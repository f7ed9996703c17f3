#!/usr/bin/env python3
"""What holds the bf16 flash-attention forward kernel back, on one NVIDIA GPU.

Run from the root of a checkout:

    python3 ablate_flash.py

It builds the kernel source `ray_tpu_torch/ops/csrc/flash_attn_fwd.cu` as
it is and in variants that each take one part of the work out (their
results are wrong; only their times mean something):

- no_exp: p = x instead of p = 2^x, so the exponent unit does nothing;
- no_softmax: the exponentials, the row reductions and the rescaling of
  O out, P left as it was;
- no_products: the wgmma products out (S and O stay as they were);
- kv_in_l2: every K and V load reads tile 0 of (b, h) = (0, 0), so that
  it hits L2 (the loads' cost with no device-memory traffic);
- by_bh: the causal launch order of one (b, h) at a time instead of the
  longest tiles first across groups of (b, h) pairs (what the order buys).

and times each at GPT-2's shape (causal), the same shape without the
causal mask (every query tile scans all keys), and 1152 one-tile CTAs
(the cost of a CTA with no scan to amortise it), beside
`scaled_dot_product_attention` on the same inputs: CUDA events, L2 flushed
before each launch, median of 25, the variants in turns, twice. One JSON
line per shape, then the card's name and power limit. Without CUDA it
exits 2.
"""

import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import torch

# (B, T, H, D, causal)
SHAPES = {"gpt2": (12, 1024, 12, 64, True),
          "gpt2_full": (12, 1024, 12, 64, False),
          "one_tile": (96, 128, 12, 64, True)}

# variant: [(text of the source, its replacement)]
VARIANTS = {
    "kernel": [],
    "no_exp": [
        ("      p[e] = ex2(fmaf(sc[4 * i + e], scale_log2, -m[e >> 1]));",
         "      p[e] = fmaf(sc[4 * i + e], scale_log2, -m[e >> 1]);")],
    "no_softmax": [
        ("    exp_pack<0, 8>(sc, pa, t, m, scale_log2);\n", ""),
        ("    exp_pack<8, 16>(sc, pa, t, m, scale_log2);\n", ""),
        ("    row_max(sc, mx);\n",
         "    mx[0] = sc[0];\n    mx[1] = sc[2];\n"),
        ("    for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];\n",
         "    for (int i = 0; i < 0; ++i)"
         " acc[i] *= corr[(i >> 1) & 1];\n")],
    "no_products": [
        ("      wgmma_qk(sc, desc_q + 2 * kk, desc_k + 2 * kk, kk);",
         "      ;"),
        ("      wgmma_pv(acc, pa + 4 * ks, desc_v + 128 * ks);", "      ;")],
    "by_bh": [("  const int group = causal ? kCausalGroup : 1;",
               "  const int group = 1;")],
    "kv_in_l2": [
        ("full_k(s), 0, h, j * kBlockK, b);", "full_k(s), 0, 0, 0, 0);"),
        ("full_v(s), 0, h, j * kBlockK, b);", "full_v(s), 0, 0, 0, 0);")],
}


def _variant_source(src, edits):
    for old, new in edits:
        if old not in src:
            raise RuntimeError(f"ablate_flash: the source no longer has "
                               f"{old.strip()!r}; update VARIANTS")
        src = src.replace(old, new)
    return src


def _build(out_dir):
    """{variant: ctypes function} built in parallel, one nvcc each."""
    from ray_tpu_torch.ops import _build as build

    src = (build.CSRC / "flash_attn_fwd.cu").read_text()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(_variant_source(src, edits))
        procs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o",
             str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns, regs = {}, {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs[name] = [int(r) for r in re.findall(r"Used (\d+) registers",
                                                 log)]
        fn = ctypes.CDLL(str(out_dir / f"{name}.so")).flash_attn_fwd_launch
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 4
                       + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_float]
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns, regs


def main():
    if not torch.cuda.is_available():
        print("ablate_flash: no CUDA device", file=sys.stderr)
        return 2
    import torch.nn.functional as F

    import chip_smoke

    dev = torch.device("cuda", 0)
    fns, regs = _build(Path(__file__).resolve().parent / "build" / "ablate")
    flush = chip_smoke.flush_buffer(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    for label, (b, t, h, d, causal) in SHAPES.items():
        qkv = torch.randn((b, t, 3 * h * d), generator=gen,
                          device=dev).bfloat16()
        q, k, v = (z.view(b, t, h, d) for z in qkv.split(h * d, dim=-1))
        out = torch.empty((b, t, h, d), dtype=torch.bfloat16, device=dev)
        st = (ctypes.c_longlong * 12)(
            *[s for x in (q, k, v, out) for s in x.stride()[:3]])

        def launch(fn):
            rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                    b, t, h, d, st, d ** -0.5, int(causal), 128, 1,
                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"launch failed: {rc}")

        qt, kt, vt = (z.transpose(1, 2) for z in (q, k, v))
        ms = {name: [] for name in [*fns, "sdpa"]}
        for _ in range(2):
            for name, fn in fns.items():
                ms[name].append(chip_smoke.time_ms(lambda: launch(fn),
                                                   flush=flush))
            ms["sdpa"].append(chip_smoke.time_ms(
                lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                       is_causal=causal),
                flush=flush))
        print(json.dumps({"shape": label, "B": b, "T": t, "H": h, "D": d,
                          "causal": causal, "ms": ms, "registers": regs}),
              flush=True)
        del qkv, q, k, v, out, qt, kt, vt
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
