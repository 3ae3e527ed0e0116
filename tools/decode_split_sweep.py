#!/usr/bin/env python3
"""Split sweep of the flash and paged decode kernels (B6/B7,
``csrc/paged_decode.cu``) on one GPU.

    python3 tools/decode_split_sweep.py [--tiles 1 2 4 8] [--out sweep.json]

For a bf16, fp8 and int8 cache at Llama-3-8B's heads (32 over 8, D 128)
and a bf16 cache at Qwen2.5-7B's (28 over 4): the device ms of one layer of
the serving engines' caches at batch 64 and lengths 0-1000, the calls
walking the 32 layers (``chip_smoke.time_serving_decode``), at every
split of the keys into runs of ``--tiles`` 64-position tiles, each output
held against the plain version within ``chip_smoke.TOL_KERNEL`` first.
One JSON line last; with ``--out`` also a file.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("decode_split_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import flash_decode as fd

    ap = argparse.ArgumentParser()
    ap.add_argument("--tiles", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build(verbose=False)
    gen = torch.Generator(device="cuda").manual_seed(8)
    rows = []
    default = dict(fd.SPLIT_TILES)
    cases = [("8B", cs.H8, cs.KVH8, "bf16"), ("8B", cs.H8, cs.KVH8, "fp8"),
             ("8B", cs.H8, cs.KVH8, "int8"),
             ("Qwen2.5-7B", 28, 4, "bf16")]
    for model, H, KVH, cache in cases:
        q, nk, nv = (cs.dev_randn(gen, cs.BATCH, h, cs.D8)
                     for h in (H, KVH, KVH))
        if cache == "bf16":
            make, ks, widen = (lambda shape: cs.dev_randn(gen, *shape)), \
                None, None
            item = 2
        else:
            dtype = torch.float8_e4m3fn if cache == "fp8" else torch.int8
            sc = cs.CACHE_SCALES[cache]
            ks = torch.tensor([sc], device="cuda")

            def make(shape, dtype=dtype, sc=sc):
                return cs.dev_cache(gen, shape, dtype, sc)

            def widen(c, sc=sc):
                return (c.float() * sc).to(torch.bfloat16)
            item = 1
        for tiles in args.tiles:
            fd.SPLIT_TILES[item] = tiles
            errs = {}
            cs.check_serving_decode(errs, np.random.default_rng(tiles), q,
                                    nk, nv, make, f"{cache} {model}", ks, ks)
            timed = cs.time_serving_decode(np.random.default_rng(0), q, nk,
                                           nv, make, f"{cache} cache", ks,
                                           ks, widen)
            for name, r in timed.items():
                rows.append(dict(model=model, cache=cache, kernel=name,
                                 tiles=tiles, ms=r["ms"],
                                 bound_ms=r["bound_ms"],
                                 library_ms=r["library_ms"],
                                 default=tiles == default[item]))
                print(f"{model} {cache} {name} split {tiles} tiles: "
                      f"{r['ms']:.4f} ms, bound {r['bound_ms']:.4f}, "
                      f"SDPA {r['library_ms']}"
                      f"{' <- default' if tiles == default[item] else ''}",
                      flush=True)
        fd.SPLIT_TILES.update(default)
        torch.cuda.empty_cache()
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
