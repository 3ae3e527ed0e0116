#!/usr/bin/env python3
"""Where the time of the latent-head decode kernels goes, from clock64()
stamps inside them (B5-L and B7-L, ``csrc/mla_decode.cu``), on one GPU.

    python3 tools/latent_stamps.py [--reps 3] [--out stamps.json]

Builds ``csrc/mla_decode.cu`` with ``-DCT_LATENT_STAMPS`` into its own
library under ``build/latent_stamps/`` (neither the main kernel library
nor ``chip_smoke.py`` builds that variant), points the wrappers at it, and
runs the rows of ``chip_smoke.timings_mla`` (V2-Lite's 16 heads on a bf16
and an fp8 slab at S_pad 1024 and 192, a bf16 and an fp8 pool; V2's 128
heads on a bf16 slab and pool; batch 64, one layer of a 27-layer cache
a call, the calls walking the layers). For each row it prints the phase
sums the kernel exports (``ct_latent_stamp_names``): cycles per stamped
unit and the share of the units' total, the counts (blocks, tiles,
segments) as they are, and the device ms of one call of the stamped
build by CUDA events (the stamps cost a few percent). One JSON line last;
with ``--out`` also a file.
"""

import argparse
import ctypes
import hashlib
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (label, wrapper, cache, S_pad, heads): chip_smoke.timings_mla's rows
ROWS = (("5L V2-Lite bf16 slab S_pad 1024", "slab", "bf16", 1024, 16),
        ("5L2 V2-Lite bf16 slab S_pad 192", "slab", "bf16", 192, 16),
        ("5L3 V2-Lite fp8 slab S_pad 1024", "slab", "fp8", 1024, 16),
        ("5L4 V2-Lite fp8 slab S_pad 192", "slab", "fp8", 192, 16),
        ("7L V2-Lite bf16 pool", "pool", "bf16", 1024, 16),
        ("7L2 V2-Lite fp8 pool", "pool", "fp8", 1024, 16),
        ("5L5 V2 bf16 slab S_pad 1024", "slab", "bf16", 1024, 128),
        ("7L3 V2 bf16 pool", "pool", "bf16", 1024, 128))


def build_stamped():
    """nvcc of mla_decode.cu (and the error strings) with the stamps on,
    into build/latent_stamps/; returns the loaded library with the
    kernel library's signatures."""
    from compressed_tensors_tpu_torch.ops.kernels import _build

    sources = [_build.CSRC / "mla_decode.cu", _build.CSRC / "errors.cu"]
    flags = [*_build.NVCC_FLAGS, "-DCT_LATENT_STAMPS"]
    digest = hashlib.sha256(
        b"".join(p.read_bytes() for p in sources + sorted(
            _build.CSRC.glob("*.cuh"))) + " ".join(flags).encode()
    ).hexdigest()[:16]
    out_dir = _build.BUILD_DIR.parent / "latent_stamps"
    out_dir.mkdir(parents=True, exist_ok=True)
    lib_path = out_dir / f"libct_latent_stamps_{digest}.so"
    if not lib_path.exists():
        nvcc = _build._nvcc()
        objs = []
        for src in sources:
            obj = out_dir / f"{src.stem}_{digest}.o"
            subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", str(src),
                            "-o", str(obj)], check=True)
            objs.append(str(obj))
        subprocess.run([nvcc, *_build.ARCH, "-shared", "-o", str(lib_path),
                        *objs], check=True)
    lib = ctypes.CDLL(str(lib_path))
    for name in ("ct_latent_decode", "ct_latent_paged_decode"):
        fn = getattr(lib, name)
        fn.argtypes = _build._SIGNATURES[name]
        fn.restype = ctypes.c_int
    lib.ct_error_string.argtypes = [ctypes.c_int]
    lib.ct_error_string.restype = ctypes.c_char_p
    lib.ct_latent_stamp_names.restype = ctypes.c_char_p
    lib.ct_latent_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ct_latent_stamps.restype = ctypes.c_int
    return lib


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("latent_stamps: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import (
        decode_attention as da,
        paged_decode as pd,
    )

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(smi, flush=True)
    lib = build_stamped()
    _build._lib = lib  # the wrappers launch the stamped kernels
    names = lib.ct_latent_stamp_names().decode().split(",")
    sums = (ctypes.c_ulonglong * len(names))()

    def read(reset):
        _build.check(lib.ct_latent_stamps(ctypes.addressof(sums), reset),
                     "ct_latent_stamps")
        return list(sums)

    gen = torch.Generator(device="cuda").manual_seed(17)
    rng = np.random.default_rng(17)
    L, dk, dv, B = 27, 576, 512, cs.BATCH
    out = {"device": smi, "rows": {}}
    for label, where, cache, s_pad, h in ROWS:
        dtype = {"bf16": torch.bfloat16, "fp8": torch.float8_e4m3fn}[cache]
        sc = cs.CACHE_SCALES.get(cache)
        ks = vs = None if sc is None else torch.tensor([sc], device="cuda")

        def make(shape):
            return (cs.dev_randn(gen, *shape) if sc is None
                    else cs.dev_cache(gen, shape, dtype, sc))

        q = cs.dev_randn(gen, B, h, dk)
        nk, nv = cs.dev_randn(gen, B, 1, dk), cs.dev_randn(gen, B, 1, dv)
        if s_pad == 192:
            lens = rng.integers(cs.PROMPT, cs.PROMPT + cs.NEW_TOKENS,
                                size=B).astype(np.int32)
        else:
            lens, _ = cs.serving_lengths(rng, B, ())
        lengths = torch.from_numpy(lens).cuda()
        kw = dict(k_scale=ks, v_scale=vs, true_d=192)
        if where == "slab":
            ck, cv = make((L, B, 1, s_pad, dk)), make((L, B, 1, s_pad, dv))
            calls = [lambda i=i: da.decode_attention(
                q, nk, nv, ck, cv, lengths, layer=i, **kw) for i in range(L)]
        else:
            tables, num_pages = cs.serving_tables(rng)
            tables_d = torch.from_numpy(tables).cuda()
            page = cs.SERVE["page_size"]
            ck = make((L, num_pages, 1, page, dk))
            cv = make((L, num_pages, 1, page, dv))
            calls = [lambda i=i: pd.paged_decode_attention(
                q, nk, nv, ck, cv, tables_d, lengths, layer=i, **kw)
                for i in range(L)]
        for call in calls:
            call()
        torch.cuda.synchronize()
        read(1)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(args.reps):
            for call in calls:
                call()
        e1.record()
        e1.synchronize()
        ms = e0.elapsed_time(e1) / (args.reps * L)
        got = dict(zip(names, read(1)))
        row = {"ms_per_call_stamped": ms, "live_positions":
               int((lens + 1).sum()), "sums": got}
        line = [f"{label}: {ms:.4f} ms a call (stamped build)"]
        for unit, parts in cs_units(names).items():
            n = max(got.get(unit, 0), 1)
            total = sum(got[p] for p in parts) or 1
            row[unit] = {p: {"cycles_per": got[p] / n,
                             "share": got[p] / total} for p in parts}
            line.append(f"  per {unit[:-1]} ({got.get(unit, 0)}): " + ", ".join(
                f"{p} {got[p] / n:.0f} cyc ({100 * got[p] / total:.1f}%)"
                for p in parts))
        counts = [k for k in names if k.endswith("s") and k not in
                  cs_units(names)]
        line.append("  totals: " + ", ".join(
            f"{k} {got[k] / max(got.get(u, 0), 1):.0f} cyc per {u[:-1]}"
            for k, u in zip([k for k in names if k.endswith("total")],
                            [u for u in cs_units(names)])))
        line.append("  counts: " + ", ".join(f"{k} {got[k]}" for k in counts))
        print("\n".join(line), flush=True)
        out["rows"][label] = row
        del ck, cv
        torch.cuda.empty_cache()
    text = json.dumps(out)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text + "\n")
    print(text)
    return 0


def cs_units(names):
    """{count name: [the phase names summed per unit of that count]}: the
    phases listed before each count of units ("blocks", "merge blocks",
    "consumer units", ...), totals ("total", "producer total") left out of
    the shares."""
    units, parts = {}, []
    for n in names:
        if n.endswith("blocks") or n.endswith("units"):
            units[n] = [p for p in parts if not p.endswith("total")]
            parts = []
        elif not n.endswith("s"):
            parts.append(n)
    return units


if __name__ == "__main__":
    sys.exit(main())
