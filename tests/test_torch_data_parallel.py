"""The port's data parallelism at four processes
(``ServingEngine(mesh=make_mesh(dp=2, tp=2))``, ``pipeline_forward`` over
a pp = 2 x dp = 2 mesh) held against the JAX package.

One spawn of four gloo ranks on the CPU (``tests/torch_dist_worker.py``
case "dp4", which imports only the port; 60 s limit a rank): the engine
at dp = 2 x tp = 2, as the JAX package's test_serving_sharded.py runs it,
on its W4A16 g32 recipe (each rank's tp blocks read by ``load_llama_
params(mesh=...)``) and its mixed W4A16/W8A8 recipe, dense and paged,
must give the JAX single-device engine's completions on every rank; and
each rank's dp block of test_pipeline.py's rows pipelined over its own pp
line must match the JAX plain forward's rows at that test's atol. The
two-rank dp cases are in ``tests/test_torch_parallel.py``."""

import json
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from compressed_tensors_tpu.models import llama as jl
from compressed_tensors_tpu.models.config import LlamaConfig as JConfig
from compressed_tensors_tpu.models.synthetic import (
    make_synthetic_llama as j_synthetic,
)
from testing_utils import make_tiny_llama_checkpoint

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402
from test_torch_parallel import (  # noqa: E402
    MIXED_W4_W8,
    W4A16_G32,
    _jax_run,
    _requests,
)

pytestmark = pytest.mark.multiprocess

SPAWN_SECONDS = 60


@pytest.fixture(scope="module")
def dp4_run(tmp_path_factory):
    """The spawned run: checkpoints, requests and rows written here, the
    ranks started, the JAX package's oracles computed here while they
    run, each rank's report and arrays read back."""
    out = tmp_path_factory.mktemp("dp4")
    oracles, requests, paths, models = {}, {}, {}, {}
    for name, recipe in (("w4", W4A16_G32), ("mixed", MIXED_W4_W8)):
        rng = np.random.default_rng(42)
        paths[name], _ = make_tiny_llama_checkpoint(out / name, rng, recipe)
        models[name] = jl.load_llama_params(paths[name], dtype=jnp.float32)
        requests[name] = _requests(rng, models[name][1])
    pcfg = JConfig(**dict(worker.PARALLEL_CFG, num_hidden_layers=4))
    ids = (np.arange(32) % pcfg.vocab_size).reshape(4, 8)
    with open(out / "inputs.json", "w") as f:
        json.dump({"requests": requests, "paths": paths}, f)
    np.savez(out / "inputs.npz", pp_ids=ids)
    ranks = worker.start("dp4", out, world=4)
    try:
        for name, (jp, jc, _) in models.items():
            oracles[name] = _jax_run(jp, jc, [requests[name]])
        forward = jax.jit(lambda p, i, q: jl.llama_forward(p, pcfg, i, q)[0])
        for preset in ("W4A16", "W8A8"):
            p = j_synthetic(pcfg, preset=preset, use_kernels=False,
                            dtype=jnp.float32)
            oracles[f"pp_{preset}"] = np.asarray(forward(
                p, jnp.asarray(ids, jnp.int32),
                jnp.broadcast_to(jnp.arange(8), (4, 8))))
    except BaseException:
        worker.stop(ranks)
        raise
    reports = worker.finish("dp4", ranks, out, SPAWN_SECONDS)
    got = [dict(np.load(out / f"rank{r}.npz")) for r in range(4)]
    return reports, got, oracles


@pytest.mark.parametrize("case,oracle", [("w4", "w4"), ("mixed", "mixed"),
                                         ("mixed_paged", "mixed")])
def test_dp2_tp2_engine_matches_jax_single_device(dp4_run, case, oracle):
    """test_serving_sharded.py's dp = 2 x tp = 2 engine over four
    processes: each rank holds two of the four kv heads and one of the two
    dp blocks, and every rank's completions are the JAX single-device
    engine's."""
    reports, _, oracles = dp4_run
    assert sorted((r["coords"]["dp"], r["coords"]["tp"])
                  for r in reports) == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in reports:
        assert r["heads"] == [2, 1]
        assert r[case]["completions"] == oracles[oracle], (case, r["rank"])


@pytest.mark.parametrize("preset,atol", [("W4A16", 2e-3), ("W8A8", 5e-2)])
def test_pipeline_pp2_dp2_matches_plain_forward(dp4_run, preset, atol):
    """test_pipeline.py's pp = 2 x dp = 2 pipeline: each rank's two rows,
    two microbatches over its pp line, against the JAX plain forward's
    rows at that test's atol."""
    reports, got, oracles = dp4_run
    for r, g in zip(reports, got):
        i = r["coords"]["dp"]
        np.testing.assert_allclose(g[f"pp_{preset}"],
                                   oracles[f"pp_{preset}"][2 * i:2 * i + 2],
                                   atol=atol)
