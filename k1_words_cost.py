#!/usr/bin/env python3
"""What storing its keep words costs the forward kernel (K1), on one NVIDIA
GPU.

    python3 k1_words_cost.py

With dropout K1 stores the keep bits it draws, one 32-bit word per thread
and tile pair, for the backward.  This script builds three copies of
``mtvaf_tpu_torch/csrc/prefix_attention_fwd.cu`` into
``build/k1_words_cost/``: as it is (``drawn``), with the words' store taken
out (``no_store``; the words are then not written), and storing a constant
word in their place (``constant``: the same bytes, but no word to put
together from the tile's 32 keep bits).  It prints the SASS instruction
count of the bf16 kernel with dropout in each (when ``cuobjdump`` is
there), then times K1 with dropout 0.1 in each copy, in turns, between
CUDA events (median of six rounds of 50 calls), at ``span_s500`` and
``span_s128`` in bf16 and at the train shape in fp32: one JSON line per
shape.  ``drawn`` must give the plain Philox mask bit for bit.  Exits
non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "mtvaf_tpu_torch" / "csrc"
OUT = ROOT / "build" / "k1_words_cost"
STORE = ("      words[hp::keep_word_index(plane, blockIdx.x, gridDim.x, j, "
         "nt)] = keep;\n")
VARIANTS = {"drawn": STORE, "no_store": "",
            "constant": STORE.replace("= keep;", "= 0xffffffffu;")}
SHAPES = {"span_s500": (32, 12, 500, 500, torch.bfloat16),
          "span_s128": (32, 12, 128, 128, torch.bfloat16),
          "train_fp32": (32, 12, 128, 144, torch.float32)}
SEED, SALT, RATE = 0x0123456789ABCDEF, 0, 0.1    # the step key's word


def build():
    """Each variant's library, and its bf16 dropout kernel's SASS count."""
    from mtvaf_tpu_torch.kernels.build import ARCH_FLAGS, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    src = (CSRC / "prefix_attention_fwd.cu").read_text()
    if src.count(STORE) != 2:
        raise RuntimeError("the forward source no longer stores its words "
                           "as this script expects")
    jobs, libs, sass = {}, {}, {}
    for name, line in VARIANTS.items():
        cu = OUT / f"{name}.cu"
        cu.write_text(src.replace(STORE, line))
        base = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", f"-I{CSRC}"]
        jobs[name] = [subprocess.Popen(
            base + args, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for args in (
                ["-shared", "-Xcompiler", "-fPIC", "-o",
                 str(OUT / f"lib{name}.so"), str(cu)],
                ["-cubin", "-o", str(OUT / f"{name}.cubin"), str(cu)])]
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    for name, procs in jobs.items():
        for p in procs:
            log, _ = p.communicate()
            if p.returncode:
                raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        if Path(cuobjdump).exists():
            text = subprocess.run([cuobjdump, "-sass",
                                   str(OUT / f"{name}.cubin")],
                                  capture_output=True, text=True).stdout
            body = re.split(r"Function : ", text)
            kernel = next(b for b in body if "fwd_bf16_kernelILb1" in b
                          .split("\n", 1)[0])
            sass[name] = len(re.findall(r"^\s+/\*[0-9a-f]{4,}\*/",
                                        kernel, re.M))
    return libs, sass


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_words_cost.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mtvaf_tpu_torch.core.rng import Key, new_key
    from mtvaf_tpu_torch.kernels import prefix_attention as pa
    libs, sass = build()
    fns = {}
    for name, lib in libs.items():
        fn = lib.mtvaf_prefix_attention_fwd
        fn.argtypes = pa._SIGNATURES[("prefix_attention_fwd",
                                      "mtvaf_prefix_attention_fwd")]
        fn.restype = ctypes.c_int
        fns[name] = fn
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    print("sass_instructions_bf16_dropout", json.dumps(sass), flush=True)
    dev = torch.device("cuda")
    stream = torch.cuda.current_stream().cuda_stream
    key = Key(new_key(SEED, dev).word, SALT)
    for shape, (b, h, s, t, dtype) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(0)
        q, k, v = (torch.randn(b, h, n, 64, device=dev, generator=g)
                   .to(dtype) for n in (s, t, t))
        bias = torch.zeros(b, 1, 1, t, device=dev)
        bias[-1, ..., -9:] = -10000.0
        o, lse = torch.empty_like(q), torch.empty(b, h, s, 1, device=dev)
        words = torch.zeros(pa.keep_words_shape(b, h, s, t),
                            dtype=torch.int32, device=dev)

        def call(name):
            err = fns[name](q.data_ptr(), k.data_ptr(), v.data_ptr(),
                            bias.data_ptr(), o.data_ptr(), lse.data_ptr(),
                            words.data_ptr(), b, h, s, t, 64, 1, 0.125,
                            pa._DTYPE_CODES[dtype], key.word.data_ptr(),
                            key.salt, *pa._dropout_args(RATE), 0, stream)
            if err:
                raise RuntimeError(f"{name}: launch failed ({err})")

        call("drawn")
        torch.cuda.synchronize()
        mismatches = int((pa.unpack_keep_words(words, (b, h, s, t))
                          != pa.keep_mask_reference(key.philox_key(), RATE,
                                                    (b, h, s, t), dev)).sum())
        times = {name: [] for name in fns}
        for rnd in range(6):
            for name in (list(fns) if rnd % 2 == 0 else list(fns)[::-1]):
                for _ in range(5):
                    call(name)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(50):
                    call(name)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 50)
        row = {"shape": shape, "B": b, "H": h, "S": s, "T": t,
               "dtype": str(dtype).split(".")[1], "rate": RATE,
               "drawn_words_mismatches": mismatches,
               "median_ms": {n: sorted(x)[len(x) // 2]
                             for n, x in times.items()}}
        print("k1_words_cost", json.dumps(row), flush=True)
        if mismatches:
            raise AssertionError(f"K1's keep words differ from the plain "
                                 f"mask: {row}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
