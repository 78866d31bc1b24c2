#!/usr/bin/env python3
"""Where the time of the bf16 backward kernel (K2) goes, on one NVIDIA GPU.

    python3 attention_phases.py

``nsys`` and ``ncu`` are not available everywhere the port runs, so this
script times the phases of K2's steps from inside the kernel.  It builds a
copy of ``mtvaf_tpu_torch/csrc/prefix_attention_bwd.cu`` into
``build/attention_phases/`` with ``clock64()`` stamps between the phases of
every step of both bf16 passes:

- ``wait``: waiting for the step's TMA tiles (the first step's wait holds
  the block's prologue: barrier set-up, the first loads and, in the dq pass,
  delta);
- ``ss``: the two products with both operands in shared memory;
- ``elem``: the element-wise work between the products (p, the keep bits,
  ds, the bf16 hi/lo packing);
- ``rs``: the products that take an operand from registers;
- ``sync``: the barrier before a stage is refilled.

It runs the copy at the train shape (B=32, H=12, S=128, T=144) and at S=512
(B=16, T=528), dropout off and on, and prints one JSON line per pass: the
mean cycles per block in each phase, the mean block time, the pass's span
from the first block's start to the last block's end, and the quantiles of
the blocks' start times (the waves).  The stamps cost a few percent; the
uninstrumented kernel's own device times are in ``chip_smoke.py``'s output.
Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
CSRC = ROOT / "mtvaf_tpu_torch" / "csrc"
OUT = ROOT / "build" / "attention_phases"
PHASES = ("wait", "ss", "elem", "rs", "sync")
SLOTS = 8192          # blocks recorded per pass

STAMPS = '''
__device__ long long g_phase[2][%(slots)d][8];
extern "C" int phases_read(long long* host) {
  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));
}
namespace {
''' % {"slots": SLOTS}


def _insert(pattern: str, text: str, body: str, before=False) -> str:
    """``text`` inserted after (or before) the one match of ``pattern``."""
    m = re.search(pattern, body)
    if m is None:
        raise RuntimeError(f"the backward source no longer has {pattern!r}")
    at = m.start() if before else m.end()
    return body[:at] + text + body[at:]


def _stamp(i: int) -> str:
    return f"    cx = clock64(); ph[{i}] += cx - c0; c0 = cx;\n"


def instrument(src: str) -> str:
    """The backward source with phase stamps in both bf16 kernels."""
    src = src.replace("namespace {\n", STAMPS, 1)
    for slot, kernel in enumerate(("dq_bf16_kernel", "dkdv_bf16_kernel")):
        start = src.index(f"{kernel}(const __grid_constant__")
        end = src.index("\n}\n", start)
        body = src[start:end]
        body = _insert(
            r"  extern __shared__ unsigned char smem_raw\[\];\n",
            "  long long c0 = clock64(), ph[5] = {0, 0, 0, 0, 0}, cx, g0;\n"
            '  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g0));\n',
            body)
        body = _insert(r"    hp::wgmma_fence\(\);\n    hp::gemm_ss\(",
                       _stamp(0), body, before=True)
        body = _insert(r"    hp::wgmma_wait_all\(\);\n    hp::fence_regs\("
                       r"(?:st|sc)\);\n    hp::fence_regs\((?:dpt|dp)\);\n",
                       _stamp(1), body)
        body = _insert(r"    hp::wgmma_fence\(\);\n    hp::gemm_rs\(",
                       _stamp(2), body, before=True)
        body = _insert(r"    hp::wgmma_wait_all\(\);\n    hp::fence_regs\("
                       r"(?:acc|dva)\);\n(?:    hp::fence_regs\(dka\);\n)?",
                       _stamp(3), body)
        body = _insert(r"    __syncthreads\(\);   // every warp is past "
                       r"stage s: refill it\n", _stamp(4), body)
        body += f'''
  if (threadIdx.x == 0) {{
    long long g1;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g1));
    const int id = (blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x +
                   blockIdx.x;
    if (id < {SLOTS}) {{
      for (int i = 0; i < 5; ++i) g_phase[{slot}][id][i] = ph[i];
      g_phase[{slot}][id][5] = g0;
      g_phase[{slot}][id][6] = g1;
    }}
  }}'''
        src = src[:start] + body + src[end:]
    return src


def build() -> ctypes.CDLL:
    from mtvaf_tpu_torch.kernels.build import ARCH_FLAGS, _nvcc
    OUT.mkdir(parents=True, exist_ok=True)
    cu = OUT / "prefix_attention_bwd_phases.cu"
    so = OUT / "libprefix_attention_bwd_phases.so"
    cu.write_text(instrument((CSRC / "prefix_attention_bwd.cu").read_text()))
    subprocess.run([_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", f"-I{CSRC}", "-o", str(so),
                    str(cu)], check=True)
    return ctypes.CDLL(str(so))


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_phases.py: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from mtvaf_tpu_torch.kernels import prefix_attention as pa
    lib = build()
    fn = lib.mtvaf_prefix_attention_bwd
    fn.argtypes = pa._SIGNATURES[("prefix_attention_bwd",
                                  "mtvaf_prefix_attention_bwd")]
    fn.restype = ctypes.c_int
    dev = torch.device("cuda")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    g = torch.Generator(device=dev).manual_seed(0)
    for shape, (b, h, s, t) in {"train": (32, 12, 128, 144),
                                "s512": (16, 12, 512, 528)}.items():
        q, k, v, do = (torch.randn(b, h, n, 64, device=dev, generator=g)
                       .to(torch.bfloat16) for n in (s, t, t, s))
        bias = torch.zeros(b, 1, 1, t, device=dev)
        bias[-1, ..., -9:] = -10000.0
        for rate in (0.0, 0.1):
            o, lse = pa.prefix_attention_cuda(q, k, v, bias, seed=1,
                                              rate=rate)
            grads = [torch.empty_like(x) for x in (q, k, v)]
            scratch = pa._bwd_scratch(q, t, rate)
            stream = torch.cuda.current_stream().cuda_stream
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                     bias.data_ptr(), o.data_ptr(), lse.data_ptr(),
                     do.data_ptr(), *(x.data_ptr() for x in grads),
                     scratch.data_ptr(), b, h, s, t, 64, 1, 0.125, 1,
                     *pa._dropout_args(1, rate), stream)
            torch.cuda.synchronize()
            if err:
                raise RuntimeError(f"instrumented backward failed: {err}")
            buf = np.zeros((2, SLOTS, 8), dtype=np.int64)
            if lib.phases_read(buf.ctypes.data_as(ctypes.c_void_p)):
                raise RuntimeError("could not read the phase stamps")
            for slot, (name, blocks) in enumerate(
                    (("dq", b * h * -(-s // 64)),
                     ("dkdv", b * h * -(-t // 64)))):
                r = buf[slot, :min(blocks, SLOTS)]
                t0 = r[:, 5].min()
                row = {"shape": shape, "B": b, "H": h, "S": s, "T": t,
                       "rate": rate, "pass": name, "blocks": int(blocks),
                       "cycles_per_block": {p: float(x) for p, x in zip(
                           PHASES, r[:, :5].mean(0))},
                       "block_us": float((r[:, 6] - r[:, 5]).mean() / 1e3),
                       "span_us": float((r[:, 6].max() - t0) / 1e3),
                       "start_us_quantiles": [
                           float(x) for x in np.quantile(
                               (r[:, 5] - t0) / 1e3, [0, .25, .5, .75, 1])]}
                print("phases", json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
