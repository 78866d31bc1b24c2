"""``mtvaf-export`` for the port: freeze a training run into a serving
bundle.  Counterpart of ``mtvaf_tpu/cli/export_main.py``.

Loads the run's predictor (``run_config.json`` + ``best_model.npz``, see
``infer.load_predictor``) and writes one ``torch.export`` program per
(stage, batch rung, platform) plus ``manifest.json`` and the weights
(``export.export_predictor``):

    python -m mtvaf_tpu_torch.cli.export_main --save_path out/ \\
        --out bundle/ --batch_sizes 1,16
    >>> from mtvaf_tpu_torch.export import load_exported_predictor
    >>> load_exported_predictor("bundle/").predict([...])

The predictor is built on ``cuda``; ``main(argv, device="cpu")`` builds it
on the CPU (export it with ``--platforms cpu`` there).
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def main(argv=None, device=None) -> dict:
    """Export the run; returns the bundle's manifest."""
    logging.basicConfig(level=logging.INFO)
    p = argparse.ArgumentParser("mtvaf-export")
    p.add_argument("--save_path", required=True,
                   help="training run directory (run_config.json + "
                        "best_model.npz)")
    p.add_argument("--out", required=True, help="bundle output directory")
    p.add_argument("--batch_sizes", default="1,16",
                   help="comma-separated batch rungs")
    p.add_argument("--platforms", default="cuda",
                   help="device types to export the programs for "
                        "(comma-separated: cpu, cuda); a program serves "
                        "only on the type it was traced on")
    p.add_argument("--bert_name", default=None,
                   help="override the run's tokenizer directory")
    p.add_argument("--bake_weights", action="store_true",
                   help="bake the weights into every rung's program "
                        "(self-contained files, each about the size of the "
                        "weights).  Default: weights.npz stored once per "
                        "bundle")
    args = p.parse_args(argv)

    from ..export import export_predictor
    from ..infer import load_predictor

    logger.info("loading predictor from %s", args.save_path)
    predictor = load_predictor(args.save_path, bert_name=args.bert_name,
                               device=device)
    manifest = export_predictor(
        predictor, args.out,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        platforms=[s.strip() for s in args.platforms.split(",")],
        bake_weights=args.bake_weights)
    total = sum(prog["bytes"] for prog in manifest["programs"])
    logger.info("wrote %d programs (%.1f MB) to %s",
                len(manifest["programs"]), total / 1e6, args.out)
    return manifest


if __name__ == "__main__":
    main()
