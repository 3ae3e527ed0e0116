"""The port's distributed layer (``compressed_tensors_tpu_torch.
distributed``) held against the JAX package's: the bin packing and the
module partition, single-process compression, and two spawned gloo
processes (``tests/torch_dist_worker.py``, which imports only the port)
that broadcast objects and recouple a ``compress_state_parallel`` state
equal to the JAX package's single-process ``compress_state`` bit for bit.
The spawned tests carry the ``multiprocess`` marker; each run has its own
time limit."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.compressors import ModelCompressor as JMC
from compressed_tensors_tpu.compressors import (
    module_graph_from_names as j_graph,
)
from compressed_tensors_tpu.distributed import assign as jassign
from compressed_tensors_tpu.distributed import module_parallel as jmp
from compressed_tensors_tpu.ops import calculate_qparams as j_qparams

from compressed_tensors_tpu_torch.distributed import assign as tassign
from compressed_tensors_tpu_torch.distributed import module_parallel as tmpar
from compressed_tensors_tpu_torch.distributed import utils as tdu
from compressed_tensors_tpu_torch.utils.safetensors_io import load_safetensors

SPAWN_SECONDS = 90

sys.path.insert(0, str(Path(__file__).resolve().parent))
import torch_dist_worker as worker  # noqa: E402


@pytest.mark.parametrize("bins", [1, 2, 3, 5])
@pytest.mark.parametrize("seed", range(3))
def test_greedy_bin_packing_equals_jax(seed, bins):
    """Identical order, bins and owners, ties included (weights drawn
    from few values)."""
    rng = np.random.default_rng(seed)
    items = [f"m{i}" for i in range(int(rng.integers(1, 30)))]
    weights = {n: int(w) for n, w in zip(items, rng.integers(1, 5,
                                                            size=len(items)))}
    got = tassign.greedy_bin_packing(list(items), bins, weights.__getitem__)
    want = jassign.greedy_bin_packing(list(items), bins, weights.__getitem__)
    assert got == want
    assert tassign.greedy_bin_packing(list(items), bins) == \
        jassign.greedy_bin_packing(list(items), bins)


def test_partition_modules_equals_jax():
    rng = np.random.default_rng(4)
    shapes = [(100, 100), (10, 10), (10, 10), (64, 16), (8, 8), (3, 7)]
    dtypes = [(np.float32, torch.float32), (np.int8, torch.int8)]
    tstates, jstates = {}, {}
    for i, shape in enumerate(shapes):
        npd, td = dtypes[i % 2]
        w = rng.standard_normal(shape).astype(npd)
        s = rng.standard_normal((shape[0], 1)).astype(np.float32)
        tstates[f"m{i}"] = {"weight": torch.from_numpy(w).to(td),
                            "weight_scale": torch.from_numpy(s)}
        jstates[f"m{i}"] = {"weight": jnp.asarray(w),
                            "weight_scale": jnp.asarray(s)}
    for n in (1, 2, 3):
        assert tmpar.partition_modules(tstates, n) == \
            jmp.partition_modules(jstates, n)


def _jax_states():
    """``test_compress_state_parallel_recouple``'s states in the JAX
    package, and its ``compress_state`` of them on one process."""
    mc = JMC.from_compression_config(worker.CONFIG)
    args = mc.quantization_config.config_groups["group_0"].weights
    rng = np.random.default_rng(3)
    states = {}
    for i, rows in enumerate(worker.ROWS):
        w = rng.normal(size=(rows, 16)).astype(np.float32)
        scale, _ = j_qparams(jnp.asarray(w.min(-1, keepdims=True)),
                             jnp.asarray(w.max(-1, keepdims=True)), args)
        states[f"m.proj{i}"] = {"weight": jnp.asarray(w),
                                "weight_scale": scale}
    return states, mc.compress_state(states, j_graph(list(states)))


def _assert_equals_jax(got):
    """A flat {module.param: tensor} state equal to the JAX single-process
    ``compress_state`` bit for bit."""
    _, want = _jax_states()
    flat = {f"{m}.{k}": np.asarray(v) for m, s in want.items()
            for k, v in s.items()}
    assert sorted(got) == sorted(flat)
    for name, ref in flat.items():
        t = got[name]
        assert str(t.dtype).split(".")[-1] == ref.dtype.name, name
        np.testing.assert_array_equal(t.numpy(), ref)


def test_single_process_compress_state_parallel_equals_compress_state():
    """Without a process group ``compress_state_parallel`` is
    ``compress_state``, and both equal the JAX package's."""
    assert not tdu.is_distributed()
    assert (tdu.process_index(), tdu.process_count()) == (0, 1)
    assert tdu.broadcast_object({"a": 1}) == {"a": 1}
    tdu.init_dist()  # a single process without arguments: nothing
    assert not torch.distributed.is_initialized()
    mc, states, modules = worker.recouple_states()
    par = tmpar.compress_state_parallel(mc, states, modules)
    mc2, states2, modules2 = worker.recouple_states()
    seq = mc2.compress_state(states2, modules2)
    assert list(par) == list(seq)
    for name in par:
        for k in par[name]:
            assert torch.equal(par[name][k], seq[name][k])
    _assert_equals_jax({f"{m}.{k}": v for m, s in par.items()
                        for k, v in s.items()})


def test_init_dist_needs_every_argument(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    with pytest.raises(ValueError, match="process id"):
        tdu.init_dist("localhost:1", 2, device="cpu")


@pytest.mark.multiprocess
def test_init_dist_and_object_broadcast(tmp_path):
    """Two gloo ranks: ``init_dist`` opens the group, each rank knows its
    index and the count, and ``broadcast_object`` delivers rank 0's and
    rank 1's objects to both (the JAX package's
    ``test_init_dist_and_object_broadcast``)."""
    reports = worker.spawn("broadcast", tmp_path, timeout=SPAWN_SECONDS)
    for rank, r in enumerate(reports):
        assert (r["rank"], r["count"], r["distributed"]) == (rank, 2, True)
        assert r["backend"] == "gloo"
        assert r["from0"] == {"payload": [1, 2, 3], "rank": 0}
        assert r["from1"] == ["from-one"]


@pytest.fixture(scope="module")
def recoupled(tmp_path_factory):
    """One spawned two-rank ``compress_state_parallel`` run: each rank's
    report and full state as it wrote them."""
    out = tmp_path_factory.mktemp("recouple")
    reports = worker.spawn("compress", out, timeout=SPAWN_SECONDS)
    states = [load_safetensors(str(out / f"rank{r}.safetensors"))
              for r in range(2)]
    return reports, states


@pytest.mark.multiprocess
def test_compress_state_parallel_recouples_on_both_ranks(recoupled):
    """Both ranks own work, and both end with the full state on the host,
    the same bytes on each."""
    reports, states = recoupled
    for r in reports:
        assert set(r["owner"].values()) == {0, 1}
        assert r["devices"] == ["cpu"]
    assert sorted(states[0]) == sorted(states[1])
    assert len({n.rsplit(".", 1)[0] for n in states[0]}) == len(worker.ROWS)
    for name, t in states[0].items():
        assert torch.equal(t, states[1][name]), name


@pytest.mark.multiprocess
def test_compress_state_parallel_equals_jax_compress_state(recoupled):
    """The recoupled state equals the JAX package's single-process
    ``compress_state`` of the same states, bit for bit, on each rank."""
    _, states = recoupled
    for state in states:
        _assert_equals_jax(state)
