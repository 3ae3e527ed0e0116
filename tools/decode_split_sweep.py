#!/usr/bin/env python3
"""Split sweep of the flash and paged decode kernels (B6/B7,
``csrc/paged_decode.cu``), and design sweep of the block decode kernel
(B5, ``csrc/decode_attention.cu``), on one GPU.

    python3 tools/decode_split_sweep.py [--tiles 1 2 4 8] [--out sweep.json]
    python3 tools/decode_split_sweep.py --block [--out sweep.json]

For a bf16, fp8 and int8 cache at Llama-3-8B's heads (32 over 8, D 128)
and a bf16 cache at Qwen2.5-7B's (28 over 4): the device ms of one layer of
the serving engines' caches at batch 64 and lengths 0-1000, the calls
walking the 32 layers (``chip_smoke.time_serving_decode``), at every
split of the keys into runs of ``--tiles`` 64-position tiles, each output
held against the plain version within ``chip_smoke.TOL_KERNEL`` first.
With ``--block``: B5's parity grid (``chip_smoke.parity_grid_block_decode``),
then its device ms in each of its two forms ("scores": the scores kept in
shared memory, K and V read once; "recompute": the scores formed again in
a second pass over K) on one layer of greedy_generate's Llama-3-8B cache
(32, 64, 8, 192, 128) at lengths 128-159 in bf16, fp8 and int8, and of
the TinyLlama cache (22, 64, 4, 192, 64) in bf16, the calls walking the
layers.
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
    ap.add_argument("--block", action="store_true")
    args = ap.parse_args()
    if args.block:
        return block_sweep(args)
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


def block_sweep(args) -> int:
    import math

    import numpy as np
    import torch

    import chip_smoke as cs
    from compressed_tensors_tpu_torch.ops.kernels import _build
    from compressed_tensors_tpu_torch.ops.kernels import decode_attention as da

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    _build.build(verbose=False)
    lib = _build.load()
    gen = torch.Generator(device="cuda").manual_seed(9)
    cs.parity_grid_block_decode({}, gen)

    def launch(q, nk, nv, ck, cv, lengths, layer, ks, vs, store):
        """decode_attention's launch in the given form (1: "scores")."""
        kind, ks, vs, stride, scaled = da.kernel_scales(
            "decode_attention", q, ck, ks, vs, per_head=True)
        B, H, D = q.shape
        KVH = nk.shape[1]
        out = torch.empty_like(q)
        _build.check(lib.ct_decode_attention(
            q.data_ptr(), nk.data_ptr(), nv.data_ptr(), ck.data_ptr(),
            cv.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            ks.data_ptr() if scaled else None,
            vs.data_ptr() if scaled else None, B, KVH, H // KVH,
            ck.shape[3], D, layer, kind, stride, store, 1.0 / math.sqrt(D),
            torch.cuda.current_stream().cuda_stream), "decode_attention")
        return out

    def forms(q, nk, nv, ck, cv, lengths, ks, vs):
        want = da.decode_attention_plain(
            q, nk, nv, ck.clone(), cv.clone(), lengths, layer=0, k_scale=ks,
            v_scale=vs)[0].float()
        live = lengths >= 0
        times = {}
        for form, store in (("scores", 1), ("recompute", 0)):
            got = launch(q, nk, nv, ck.clone(), cv.clone(), lengths, 0, ks,
                         vs, store).float()
            rel = ((got[live] - want[live]).abs().max()
                   / want[live].abs().max()).item()
            if rel > cs.TOL_KERNEL:
                raise AssertionError(f"block decode {form}: {rel} of "
                                     "max|plain|")
            times[form] = cs.device_ms([lambda i=i, st=store: launch(
                q, nk, nv, ck, cv, lengths, i, ks, vs, st)
                for i in range(ck.shape[0])])
        return times

    rows = []
    rng = np.random.default_rng(9)
    q, nk, nv = (cs.dev_randn(gen, cs.BATCH, h, cs.D8)
                 for h in (cs.H8, cs.KVH8, cs.KVH8))
    lengths = torch.from_numpy(rng.integers(
        cs.PROMPT, cs.PROMPT + cs.NEW_TOKENS, cs.BATCH).astype(np.int32)).cuda()
    for cache in ("bf16", "fp8", "int8"):
        shape = (cs.L8, cs.BATCH, cs.KVH8, 192, cs.D8)
        if cache == "bf16":
            ck, cv = (cs.dev_randn(gen, *shape) for _ in range(2))
            ks = None
        else:
            dtype = torch.float8_e4m3fn if cache == "fp8" else torch.int8
            sc = cs.CACHE_SCALES[cache]
            ks = torch.tensor([sc], device="cuda")
            ck, cv = (cs.dev_cache(gen, shape, dtype, sc) for _ in range(2))
        times = forms(q, nk, nv, ck, cv, lengths, ks, ks)
        rows.append(dict(shape="8B", cache=cache, ms=times))
        print(f"block decode 8B {cache}: scores {times['scores']:.4f} ms, "
              f"recompute {times['recompute']:.4f} ms", flush=True)
        del ck, cv
        torch.cuda.empty_cache()
    q, nk, nv, ck, cv, lengths = cs.decode_inputs(rng, "cuda")
    times = forms(q, nk, nv, ck, cv, lengths, None, None)
    rows.append(dict(shape="TinyLlama", cache="bf16", ms=times))
    print(f"block decode TinyLlama bf16: scores {times['scores']:.4f} ms, "
          f"recompute {times['recompute']:.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    print(json.dumps({"device": smi, "rows": len(rows)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
