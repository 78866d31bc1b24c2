"""The port side of ``mtvaf-parity``: the real-data accuracy-parity harness
with the port's CLI as "ours".

Given a directory with Twitter2015/2017 in the reference layout (the
reference path tables, MTVAF_training.py:52-192) plus local HF/torchvision
checkpoints, runs each of the five BASELINE.json configs through both the
reference's own trainer and the port's CLI (``cli.main.main``, on
``--our_device``, ``cuda`` by default), and writes the acc/macro-F1
parity table with the 0.3-point verdict per config:

  python -m mtvaf_tpu_torch.parity.harness --data_root /path/to/data \\
      --bert_name /ckpt/bert-base-uncased --roberta_name /ckpt/roberta-base \\
      --resnet_root /ckpt/resnets --out parity_out

Without real data, ``--dry_run`` generates the synthetic reference-layout
tree and checkpoints (:mod:`.synth`: 768 wide, 8 layers, a ResNet-152) and
runs the same plumbing end to end, marking the verdict "n/a (synthetic)"
since random-init runs on random data are not expected to agree.  Unlike
the JAX harness's dry run, which forces its runs onto the CPU, the dry run
keeps ``--our_device``: the port runs on the card unless asked
(``--our_device cpu``).  Each "ours" child prints the K1/K2 launch counts
as its log's last line; the row carries them (``our_launches``) and the
child's seconds (``our_seconds``).

On real data both sides start from the same pretrained checkpoints, so the
final F1s are comparable runs of the same experiment (seeded independently;
the 0.3-point budget is the BASELINE.json tolerance, not a bitwise claim).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .refrun import parse_reference_log, run_reference, stage_reference

# The five benchmark configs (BASELINE.json "configs"; CLI mapping in
# docs/CONFIGS.md).  Flags listed here are passed to BOTH sides — the
# Config surface mirrors the reference's argparse names exactly.
CONFIGS = {
    "c1": {"title": "BERT-base text-only span ABSA",
           "datasets": ["twitter15"], "flags": [], "backbone": "bert"},
    "c2": {"title": "+ aux image-to-text channel (captions/OCR/ANPs)",
           "datasets": ["twitter15"], "flags": ["--use_align"],
           "backbone": "bert"},
    "c3": {"title": "+ visual-feature branch, cross-modal fusion",
           "datasets": ["twitter2017"],
           "flags": ["--use_prefix", "--use_152"], "backbone": "bert",
           "needs_resnet": True},
    "c4": {"title": "RoBERTa-base multi-level alignment",
           "datasets": ["twitter2015"], "flags": ["--use_align"],
           "backbone": "roberta"},
    "c5": {"title": "full MTVAF (align + fusion + vao + probe)",
           "datasets": ["twitter2015", "twitter2017"],
           "flags": ["--use_align", "--use_prefix", "--use_152", "--vao",
                     "--use_probe"],
           "backbone": "bert", "needs_resnet": True, "needs_probe": True},
}

_OURS_BOOTSTRAP = """\
import json
import sys
sys.path.insert(0, {repo!r})
from mtvaf_tpu_torch.cli.main import main
from mtvaf_tpu_torch.kernels import prefix_attention as pa
main({args!r}, device={device!r})
print("parity: launches " + json.dumps(
    {{"k1": pa.prefix_attention.launches.value,
      "k2": pa.prefix_attention_bwd_cuda.launches.value}}), flush=True)
"""


def _run_ours(args: List[str], log_path: str, device: str = "cuda",
              timeout: Optional[float] = None) -> int:
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    code = _OURS_BOOTSTRAP.format(repo=repo, device=device, args=list(args))
    with open(log_path, "w") as log:
        proc = subprocess.run([sys.executable, "-c", code], stdout=log,
                              stderr=subprocess.STDOUT, timeout=timeout)
    return proc.returncode


def parse_our_launches(text: str) -> Optional[Dict[str, int]]:
    """The K1/K2 launch counts an "ours" child printed last, or None."""
    found = re.findall(r"^parity: launches (\{.*\})$", text, re.M)
    return json.loads(found[-1]) if found else None


def run_config(key: str, ns, out_dir: str) -> List[Dict]:
    """Run one config (both sides, every dataset); returns table rows."""
    spec = CONFIGS[key]
    rows = []
    backbone = ns.roberta_name if spec["backbone"] == "roberta" \
        else ns.bert_name
    for dataset in spec["datasets"]:
        tag = f"{key}_{dataset}"
        run_dir = os.path.join(out_dir, tag)
        os.makedirs(run_dir, exist_ok=True)
        common = ["--dataset_name", dataset, "--do_train",
                  "--bert_name", backbone,
                  "--num_epochs", str(ns.num_epochs),
                  "--eval_begin_epoch", str(ns.eval_begin_epoch),
                  "--train_batch_size", str(ns.train_batch_size),
                  "--eval_batch_size", str(ns.eval_batch_size),
                  "--lr", str(ns.lr), "--warmup_ratio", str(ns.warmup_ratio),
                  "--seed", str(ns.seed), "--max_seq", str(ns.max_seq),
                  "--max_seq_agn", str(ns.max_seq_agn)] + spec["flags"]
        if spec.get("needs_resnet"):
            # the reference's own --prefix_len default (10) breaks its
            # guide reshape — the model requires 4 multi-scale guides
            # (bert_model.py:382-383 '.view(bsz, prefix_len, -1)' into
            # Linear(3840, ...)); pass the working value to both sides
            common += ["--resnet_root", ns.resnet_root, "--prefix_len", "4"]

        ref: Dict[str, Optional[float]] = {"dev_f1": None, "test_f1": None}
        ref_rc = None
        if not ns.skip_reference:
            staging = os.path.join(out_dir, "_reference_staging")
            stage_reference(ns.reference_path, ns.data_root, staging)
            # the reference uses cache_dir as a string PREFIX
            # (models/utils.py:650 cache_path = cache_dir + name) — keep the
            # trailing separator and pre-create the directory
            cache = os.path.join(staging, "image_cache") + os.sep
            # pipeline A writes per-image caches into tw{15,17}_img/
            # subdirectories it never creates (models/utils.py:635-637)
            for sub in ("tw15_img", "tw17_img"):
                os.makedirs(os.path.join(cache, sub), exist_ok=True)
            ref_args = common + ["--save_path",
                                 os.path.abspath(
                                     os.path.join(run_dir, "ref_save")),
                                 "--cache_dir", cache,
                                 "--notes", tag]
            if ns.reference_device == "cpu":
                ref_args += ["--no_cuda"]
            log = os.path.join(run_dir, "reference.log")
            print(f"[{tag}] reference: {' '.join(ref_args)}", flush=True)
            ref_rc = run_reference(staging, ref_args, log,
                                   python=ns.reference_python)
            with open(log) as f:
                ref = parse_reference_log(f.read())
            if ref_rc != 0:
                print(f"[{tag}] reference FAILED (rc={ref_rc}) — see {log}",
                      flush=True)

        our_args = common + ["--data_root", ns.data_root, "--save_path",
                             os.path.join(run_dir, "our_save"), "--no_bf16"]
        if spec.get("needs_probe") and ns.probe_ckpt:
            our_args += ["--probe_ckpt", ns.probe_ckpt]
        log = os.path.join(run_dir, "ours.log")
        print(f"[{tag}] ours: {' '.join(our_args)}", flush=True)
        t0 = time.perf_counter()
        our_rc = _run_ours(our_args, log, device=ns.our_device)
        our_seconds = time.perf_counter() - t0
        with open(log) as f:
            launches = parse_our_launches(f.read())
        ours: Dict[str, Optional[float]] = {"dev_f1": None, "test_f1": None}
        fm = os.path.join(run_dir, "our_save", "final_metrics.json")
        if os.path.exists(fm):
            with open(fm) as f:
                m = json.load(f)
            ours = {"dev_f1": m.get("best_dev_f1"),
                    "test_f1": m.get("test_f1")}
        if our_rc != 0:
            print(f"[{tag}] ours FAILED (rc={our_rc}) — see {log}",
                  flush=True)

        delta = None
        if ref["test_f1"] is not None and ours["test_f1"] is not None:
            delta = abs(ref["test_f1"] - ours["test_f1"]) * 100.0
        rows.append({
            "config": key, "title": spec["title"], "dataset": dataset,
            "ref_dev_f1": ref["dev_f1"], "ref_test_f1": ref["test_f1"],
            "our_dev_f1": ours["dev_f1"], "our_test_f1": ours["test_f1"],
            "delta_test_pts": None if delta is None else round(delta, 3),
            "within_0.3_pts": (None if delta is None or ns.dry_run
                               else bool(delta <= 0.3)),
            "ref_rc": ref_rc, "our_rc": our_rc,
            "our_seconds": round(our_seconds, 1), "our_launches": launches,
        })
        print(f"[{tag}] row: {json.dumps(rows[-1])}", flush=True)
    return rows


def write_report(rows: List[Dict], out_dir: str, ns) -> None:
    with open(os.path.join(out_dir, "parity.json"), "w") as f:
        json.dump({"tolerance_pts": 0.3, "dry_run": ns.dry_run,
                   "num_epochs": ns.num_epochs, "seed": ns.seed,
                   "rows": rows}, f, indent=1)
    lines = ["# MTVAF parity run", "",
             f"epochs={ns.num_epochs} seed={ns.seed} "
             f"tolerance=0.3 pts{' (DRY RUN on synthetic data)' if ns.dry_run else ''}",
             "",
             "| config | dataset | ref test F1 | ours test F1 | Δ (pts) | verdict |",
             "|---|---|---|---|---|---|"]
    for r in rows:
        def fmt(v):
            return "—" if v is None else f"{v:.4f}"
        verdict = ("n/a (synthetic)" if ns.dry_run else
                   "—" if r["within_0.3_pts"] is None else
                   "PASS" if r["within_0.3_pts"] else "FAIL")
        lines.append(f"| {r['config']} | {r['dataset']} | "
                     f"{fmt(r['ref_test_f1'])} | {fmt(r['our_test_f1'])} | "
                     f"{'—' if r['delta_test_pts'] is None else r['delta_test_pts']} "
                     f"| {verdict} |")
    with open(os.path.join(out_dir, "PARITY_RUN.md"), "w") as f:
        f.write("\n".join(lines) + "\n")
    print("\n".join(lines), flush=True)


def main(argv=None):
    p = argparse.ArgumentParser(
        "mtvaf-parity-torch",
        description="Run the 5 BASELINE.json configs through the reference "
                    "AND the port's CLI; emit the accuracy-parity table.")
    p.add_argument("--data_root", default=None,
                   help="directory holding the reference data layout "
                        "(data/twitter2015/..., see docs/CONFIGS.md)")
    p.add_argument("--bert_name", default=None,
                   help="local bert-base-uncased checkpoint directory")
    p.add_argument("--roberta_name", default=None,
                   help="local roberta-base checkpoint directory (config 4)")
    p.add_argument("--resnet_root", default=None,
                   help="directory with torchvision resnet152.pth (c3/c5)")
    p.add_argument("--probe_ckpt", default=None,
                   help="psdProbe .pt for config 5 (ours side; the "
                        "reference loads models/psdProbe_base_savel7.pt "
                        "from its own tree)")
    p.add_argument("--reference_path", default=None,
                   help="the reference's checkout (MTVAF_training.py at its "
                        "root); needed unless --skip_reference")
    p.add_argument("--reference_python", default=None,
                   help="interpreter for the reference runs (an env with "
                        "its real deps; stubs cover missing ones)")
    p.add_argument("--reference_device", choices=("cuda", "cpu"),
                   default="cuda", help="cuda falls back to cpu when no "
                                        "GPU is visible (reference behavior)")
    p.add_argument("--our_device", default="cuda",
                   help="torch device of the port's runs (cuda by default; "
                        "the dry run keeps it)")
    p.add_argument("--configs", default="c1,c2,c3,c4,c5")
    p.add_argument("--out", default="parity_out")
    p.add_argument("--num_epochs", type=int, default=35)
    p.add_argument("--eval_begin_epoch", type=int, default=16)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--eval_batch_size", type=int, default=16)
    p.add_argument("--lr", type=float, default=5e-5)
    p.add_argument("--warmup_ratio", type=float, default=0.01)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--max_seq", type=int, default=128)
    p.add_argument("--max_seq_agn", type=int, default=500)
    p.add_argument("--skip_reference", action="store_true")
    p.add_argument("--dry_run", action="store_true",
                   help="no real data: build the synthetic reference-layout "
                        "tree + tiny checkpoints and validate the whole "
                        "harness end-to-end")
    ns = p.parse_args(argv)

    os.makedirs(ns.out, exist_ok=True)
    if ns.dry_run:
        from .synth import (build_bert_dir, build_data_tree,
                            build_resnet_pth)
        synth = os.path.join(ns.out, "synthetic")
        print("dry run: building synthetic tree under", synth, flush=True)
        ns.data_root = build_data_tree(synth)
        ns.bert_name = build_bert_dir(os.path.join(synth, "ckpt", "bert"))
        ns.roberta_name = build_bert_dir(
            os.path.join(synth, "ckpt", "roberta"), kind="roberta")
        ns.resnet_root = build_resnet_pth(os.path.join(synth, "ckpt",
                                                       "resnets"))
        ns.probe_ckpt = next(
            (p for p in (os.path.join(ns.reference_path,
                                      "psdProbe_base_savel7.pt"),
                         os.path.join(ns.reference_path, "probes",
                                      "psdProbe_base_savel7.pt"))
             if os.path.exists(p)), None) if ns.reference_path else None
        # tiny schedule: the dry run validates structure, not accuracy
        ns.num_epochs = min(ns.num_epochs, 2)
        ns.eval_begin_epoch = 1
        ns.train_batch_size = min(ns.train_batch_size, 4)
        ns.eval_batch_size = min(ns.eval_batch_size, 4)
        ns.max_seq = min(ns.max_seq, 48)
        ns.max_seq_agn = min(ns.max_seq_agn, 80)
        ns.reference_device = "cpu"
    missing = [name for name, v in
               (("--data_root", ns.data_root), ("--bert_name", ns.bert_name))
               if not v]
    if missing:
        p.error(f"{', '.join(missing)} required (or --dry_run)")
    if not ns.skip_reference and not ns.reference_path:
        p.error("--reference_path required (or --skip_reference)")

    rows = []
    for key in ns.configs.split(","):
        key = key.strip()
        if key not in CONFIGS:
            p.error(f"unknown config {key!r} (choose from {list(CONFIGS)})")
        if CONFIGS[key]["backbone"] == "roberta" and not ns.roberta_name:
            print(f"[{key}] skipped: --roberta_name not given", flush=True)
            continue
        if CONFIGS[key].get("needs_resnet") and not ns.resnet_root:
            print(f"[{key}] skipped: --resnet_root not given", flush=True)
            continue
        rows.extend(run_config(key, ns, ns.out))
    write_report(rows, ns.out, ns)
    return rows


if __name__ == "__main__":
    main()
