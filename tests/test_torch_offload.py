"""The port's offload layer (``compressed_tensors_tpu_torch.offload``) held
against the JAX package's: the planner's plans, the caches' read-backs
bit for bit (bf16 and fp8 included), ``DiskCache`` files read across the
two packages, adoption of a checkpoint shard with its symlink and inode
behaviour, and ``stream_modules`` over a tiny Llama checkpoint."""

import gc
import os
import pathlib
import threading
import weakref

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from compressed_tensors_tpu.offload import cache as jc
from compressed_tensors_tpu.offload import dispatch as jd
from compressed_tensors_tpu.offload import load as jload
from compressed_tensors_tpu.utils import safetensors_io as jio
from testing_utils import make_tiny_llama_checkpoint
from torch_port_utils import TORCH_TINY_CONFIG, to_torch, w4a16_config

from compressed_tensors_tpu_torch.offload import cache as tc
from compressed_tensors_tpu_torch.offload import dispatch as td
from compressed_tensors_tpu_torch.offload import load as tload
from compressed_tensors_tpu_torch.utils import safetensors_io as tio

# ------------------------------------------------------------------ #
# the planner

LIN = 8 * 8 * 4
MODEL = {"decoder0.linear0": LIN, "decoder0.linear1": LIN,
         "decoder1.linear0": LIN, "decoder1.linear1": LIN}
TOTAL = sum(MODEL.values())

# the size tables of tests/test_offload/test_dispatch.py and
# test_offload_distributed.py, with their device budgets
PLAN_CASES = [
    ({"a": 4, "b": 4, "c": 4}, [16, 16]),
    ({"a": 10, "b": 10, "c": 10}, [12, 12]),
    (MODEL, [TOTAL]),
    (MODEL, [2 * LIN, TOTAL - 2 * LIN]),
    ({"decoder0": 2 * LIN, "decoder1": 2 * LIN}, [LIN, TOTAL]),
    (MODEL, [LIN, TOTAL - LIN]),
    ({"decoder0.linear0": LIN, "decoder0.linear1": LIN, "decoder1": 2 * LIN},
     [2 * LIN]),
    (MODEL, [0]),
    ({"a": 10, "b": 20}, [100]),
    ({"a": 60, "b": 60}, [100, 100]),
    ({"a": 40, "b": 40}, [100, 100]),
    ({"a": 80, "b": 80, "c": 300}, [100, 100]),
    ({}, [100]),
]


def _random_table(seed):
    rng = np.random.default_rng(seed)
    n = int(rng.integers(3, 40))
    sizes = {f"model.layers.{i}": int(s)
             for i, s in enumerate(rng.integers(1, 1000, size=n))}
    total = sum(sizes.values())
    budgets = [int(b) for b in rng.integers(0, total, size=rng.integers(1, 5))]
    return sizes, budgets


@pytest.mark.parametrize("sizes,budgets", PLAN_CASES + [
    _random_table(s) for s in range(12)])
def test_dispatch_plan_equals_jax(sizes, budgets):
    """The same plan, module for module, in the same order; the host
    fallback and the no-offload refusal as in the JAX package."""
    got = td.dispatch_plan(sizes, budgets)
    want = jd.dispatch_plan(sizes, budgets)
    assert list(got.items()) == list(want.items())
    try:
        want = jd.dispatch_plan(sizes, budgets, allow_host_offload=False)
    except jd.SearchFailureError:
        with pytest.raises(td.SearchFailureError):
            td.dispatch_plan(sizes, budgets, allow_host_offload=False)
    else:
        assert td.dispatch_plan(sizes, budgets,
                                allow_host_offload=False) == want


@pytest.mark.parametrize("reserve", [0, 3, 40, 200])
def test_greedy_dispatch_equals_jax(reserve):
    for seed in range(8):
        sizes, budgets = _random_table(100 + seed)
        assert td._greedy_dispatch(sizes, budgets, reserve) == \
            jd._greedy_dispatch(sizes, budgets, reserve)


def test_max_binary_search_equals_jax():
    cases = [(lambda i: i * 2, lambda v: v <= 10, 0, 100),
             (lambda i: i * 2, lambda v: v <= 14, 0, 100),
             (lambda i: i * i, lambda v: v < 1000, 3, 31),
             (lambda i: 3 * i + 1, lambda v: v < 50, 0, 1000)]
    for fn, cond, lo, hi in cases:
        assert td.max_binary_search(fn, cond, lo, hi) == \
            jd.max_binary_search(fn, cond, lo, hi)
    for mod in (td, jd):
        with pytest.raises(mod.SearchFailureError):
            mod.max_binary_search(lambda i: i, lambda v: v < 0, 0, 10)
    assert issubclass(td.SearchFailureError, ValueError)


def test_get_device_map_and_dispatch_with_map_on_the_cpu():
    """A CPU device is unbounded in both packages; placement follows the
    plan, -1 to the host, and a module the plan lacks raises KeyError."""
    import jax

    sizes = {"m.a": 128, "m.b": 128}
    plan = td.get_device_map(sizes, devices=["cpu"])
    assert plan == jd.get_device_map(sizes, devices=jax.devices()[:1])
    params = {"m.a": {"weight": torch.ones(2, 2)},
              "m.b": {"weight": torch.zeros(2, 2), "bias": [torch.ones(2)]}}
    placed = td.dispatch_with_map(params, plan, devices=["cpu"])
    assert placed["m.b"]["bias"][0].device.type == "cpu"
    assert torch.equal(placed["m.a"]["weight"], params["m.a"]["weight"])
    host = td.dispatch_with_map(params, {"m.a": -1, "m.b": -1})
    assert host["m.b"]["weight"].device.type == "cpu"
    with pytest.raises(KeyError):
        td.dispatch_with_map(params, {"m.a": 0})


def test_entry_points_take_the_card_by_default(monkeypatch, tmp_path):
    """Without ``device="cpu"`` (or a CPU device list) the entry points
    ask for the card, and raise where there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (tc.HostCache, tc.DeviceCache,
                 lambda: tc.DiskCache(str(tmp_path / "d"))):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.get_device_map({"a": 1})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        td.dispatch_with_map({"a": {"w": torch.ones(1)}}, {"a": 0})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        next(tload.stream_modules(str(tmp_path)))


# ------------------------------------------------------------------ #
# the caches

DTYPES = {"f32": (np.float32, torch.float32),
          "bf16": (ml_dtypes.bfloat16, torch.bfloat16),
          "fp8": (ml_dtypes.float8_e4m3fn, torch.float8_e4m3fn),
          "int8": (np.int8, torch.int8)}


def _value(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32) * 3
    if dtype == "int8":
        return np.clip(np.round(x * 20), -128, 127).astype(np.int8)
    return x.astype(DTYPES[dtype][0])


def _pair(kind, tmp_path):
    if kind == "host":
        return tc.HostCache(onload_device="cpu"), jc.HostCache()
    if kind == "device":
        return tc.DeviceCache(onload_device="cpu"), jc.DeviceCache()
    return (tc.DiskCache(str(tmp_path / "port"), onload_device="cpu"),
            jc.DiskCache(str(tmp_path / "jax")))


def _bits(t):
    """The bytes of a torch tensor or a JAX/numpy array as integers."""
    if isinstance(t, torch.Tensor):
        t = t.detach().cpu()
        if t.is_floating_point() and t.dtype.itemsize < 4:
            t = t.view({2: torch.int16, 1: torch.uint8}[t.dtype.itemsize])
        return t.numpy()
    a = np.asarray(t)
    if a.dtype.kind == "V" or a.dtype.name in ("bfloat16",) or \
            a.dtype.name.startswith("float8"):
        return a.view({2: np.int16, 1: np.uint8}[a.dtype.itemsize])
    return a


def _same(got, want):
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert tuple(got.shape) == tuple(np.shape(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kind", ["host", "device", "disk"])
def test_cache_sequence_matches_jax_bit_for_bit(kind, dtype, tmp_path):
    """Set, read, update in place, update to another shape, delete, and
    read under ``disable_offloading`` and ``disable_onloading``: every
    read-back equal to the JAX cache's bit for bit, the stored
    representation of the same kind (a host tensor where JAX keeps a
    numpy array, a file path where JAX keeps one)."""
    rng = np.random.default_rng(len(kind) * 10 + len(dtype))
    port, ref = _pair(kind, tmp_path)
    seq = [("w", (4, 8)), ("b", (8,)), ("w", (4, 8)), ("w", (2, 16)),
           ("b", (3,))]
    for name, shape in seq:
        v = _value(rng, shape, dtype)
        port[name] = to_torch(v)
        ref[name] = jnp.asarray(v)
        _same(port[name], ref[name])
    assert sorted(port) == sorted(ref) and len(port) == len(ref)
    with jc.disable_offloading(), tc.disable_offloading():
        first = port["w"]
        assert port["w"] is first
        _same(first, ref["w"])
    with jc.disable_onloading(), tc.disable_onloading():
        raw, jraw = port["w"], ref["w"]
    if kind == "disk":
        assert isinstance(raw, str) and os.path.exists(raw)
        assert isinstance(jraw, str)
    else:
        assert isinstance(raw, torch.Tensor) and raw.device.type == "cpu"
        _same(raw, jraw)
    del port["b"], ref["b"]
    assert "b" not in port and len(port) == 1
    with pytest.raises(KeyError):
        port["b"]


def test_host_cache_updates_in_place():
    """A matching shape and dtype lands in the stored host tensor itself;
    another dtype or shape re-offloads (``update_offload``)."""
    cache = tc.HostCache(onload_device="cpu")
    cache["w"] = torch.zeros(4)
    buf = cache._store["w"]
    cache["w"] = torch.ones(4)
    assert cache._store["w"] is buf and torch.equal(cache["w"], torch.ones(4))
    cache["w"] = torch.ones(4, dtype=torch.int32)
    assert cache._store["w"] is not buf
    assert cache["w"].dtype == torch.int32
    # the onloaded copy is a copy: a later in-place update leaves it
    before = cache["w"]
    cache["w"] = torch.full((4,), 7, dtype=torch.int32)
    assert int(before[0]) == 1 and int(cache["w"][0]) == 7


def test_disable_offloading_leaves_copies_until_evict():
    """As the JAX package does (tests/test_offload/test_cache_behaviors.py
    ``test_disable_offloading_pins_then_releases``), leaving
    ``disable_offloading`` keeps the copies it pinned in ``_onloaded``
    until ``evict()``. The upstream library clears them when the context
    exits (``keep_onloaded_values.clear()`` in its ``finally``), so an
    onloaded copy there is collectable right after the context: the port
    keeps the JAX package's behaviour, not the upstream one."""
    for pkg, kw in ((tc, {"onload_device": "cpu"}), (jc, {})):
        cache = pkg.HostCache(**kw)
        cache["w"] = np.ones(8, np.float32) if pkg is jc else torch.ones(8)
        with pkg.disable_offloading():
            r = weakref.ref(cache["w"])
            gc.collect()
            assert r() is not None
        gc.collect()
        assert r() is not None and "w" in cache._onloaded
        cache.evict()
        gc.collect()
        assert r() is None and not cache._onloaded


def test_disable_contexts_nest_and_are_thread_local():
    cache = tc.HostCache(onload_device="cpu")
    cache["w"] = torch.ones(4)
    seen = {}
    with tc.disable_offloading():
        a = cache["w"]
        with tc.disable_offloading():
            assert cache["w"] is a
        assert cache["w"] is a
    with tc.disable_onloading():
        with tc.disable_onloading():
            assert cache["w"] is cache._store["w"]
        worker = threading.Thread(target=lambda: seen.update(w=cache["w"]))
        worker.start()
        worker.join()
        assert cache["w"] is cache._store["w"]
    assert seen["w"] is not cache._store["w"]
    assert cache["w"] is not cache._store["w"]


# ------------------------------------------------------------------ #
# DiskCache across the packages

def test_disk_cache_files_cross_read(tmp_path, rng):
    """A file the port's DiskCache writes reads back in the JAX
    ``SafetensorsFile``, and one the JAX DiskCache writes reads back in
    the port's, bf16 and fp8 included."""
    port = tc.DiskCache(str(tmp_path / "port"), onload_device="cpu")
    ref = jc.DiskCache(str(tmp_path / "jax"))
    for dtype in DTYPES:
        v = _value(rng, (3, 5), dtype)
        port[dtype] = to_torch(v)
        ref[dtype] = jnp.asarray(v)
        for path, read in ((port._store[dtype], jio.SafetensorsFile),
                           (ref._store[dtype], tio.SafetensorsFile)):
            f = read(path)
            try:
                _same(f.get("tensor"), v)
            finally:
                f.close()
        assert os.path.getsize(port._store[dtype]) == os.path.getsize(
            ref._store[dtype])


def _shard(tmp_path):
    """The shard of a tiny JAX-written W4A16 Llama checkpoint and a
    tensor in it."""
    path, _ = make_tiny_llama_checkpoint(
        pathlib.Path(tmp_path) / "ckpt", np.random.default_rng(5),
        w4a16_config(), model_config=TORCH_TINY_CONFIG)
    shard = tio.get_checkpoint_files(str(path))[0]
    name = "model.layers.0.self_attn.q_proj.weight_packed"
    return str(path), shard, name


def test_adopt_update_and_save_checkpoint_as_jax(tmp_path):
    """Adopt two tensors of a checkpoint shard, update one: in both
    packages the adopted entry is a link to the shard whose tensor reads
    back equal, the update breaks the link and leaves the shard's bytes,
    ``save_checkpoint`` links the clean entry inode-equal to the shard
    and writes the dirty one, and deleting an adopted entry removes only
    the link."""
    _, shard, name = _shard(tmp_path)
    other = "model.layers.0.mlp.down_proj.weight_scale"
    src = open(shard, "rb").read()
    f = jio.SafetensorsFile(shard)
    want, want_other = np.asarray(f.get(name)), np.asarray(f.get(other))
    f.close()
    outs = {}
    for label, cache, update in (
            ("port", tc.DiskCache(str(tmp_path / "p"), onload_device="cpu"),
             lambda c, v: c.__setitem__("dirty", torch.from_numpy(v))),
            ("jax", jc.DiskCache(str(tmp_path / "j")),
             lambda c, v: c.__setitem__("dirty", jnp.asarray(v)))):
        cache.adopt("clean", shard, name)
        cache.adopt("dirty", shard, other)
        assert cache.is_adopted("clean") and cache.is_adopted("dirty")
        assert os.path.samefile(cache._store["clean"], shard)
        _same(cache["clean"], want)
        _same(cache["dirty"], want_other)
        update(cache, np.asarray(want_other) * 3)
        assert not cache.is_adopted("dirty") and cache.is_adopted("clean")
        assert open(shard, "rb").read() == src
        out = cache.save_checkpoint(str(tmp_path / f"save_{label}"))
        assert os.path.islink(out["clean"])
        assert os.stat(out["clean"]).st_ino == os.stat(shard).st_ino
        assert not os.path.islink(out["dirty"])
        g = tio.SafetensorsFile(out["dirty"])
        outs[label] = g.get("tensor")
        g.close()
        link = cache._store["clean"]
        del cache["clean"]
        assert os.path.exists(shard) and not os.path.lexists(link)
    _same(outs["port"], outs["jax"])
    _same(outs["port"], np.asarray(want_other) * 3)


def test_disk_cache_refuses_foreign_paths(tmp_path):
    cache = tc.DiskCache(str(tmp_path / "off"), onload_device="cpu")
    foreign = str(tmp_path / "foreign.safetensors")
    tio.save_safetensors(foreign, {"tensor": torch.zeros(2)})
    cache._store["w"] = foreign
    with pytest.raises(AssertionError, match="refusing"):
        cache["w"] = torch.ones(2)
    del cache["w"]
    assert os.path.exists(foreign)
    cache["a"] = torch.ones(2)
    path = cache._store["a"]
    del cache["a"]
    cache["b"] = torch.ones(2)
    assert cache._store["b"] != path and not os.path.exists(path)


# ------------------------------------------------------------------ #
# stream_modules

def test_stream_modules_equals_jax(tmp_path):
    """A plan mixing 0 and -1 over a tiny Llama checkpoint: the module
    order, the names and every tensor equal the JAX ``stream_modules``'
    bit for bit; the host-planned modules are host tensors in the port
    where the JAX package yields numpy arrays."""
    path, _, _ = _shard(tmp_path)
    names = tio.CheckpointReader(path).module_names()
    plan = {n: (-1 if i % 3 == 1 else 0) for i, n in enumerate(names)}
    got = list(tload.stream_modules(path, plan, device="cpu"))
    want = list(jload.stream_modules(path, plan))
    assert [n for n, _ in got] == [n for n, _ in want] == names
    for (name, state), (_, ref) in zip(got, want):
        assert list(state) == list(ref)
        for key, t in state.items():
            assert t.device.type == "cpu"
            _same(t, ref[key])
        if plan[name] < 0:
            assert all(isinstance(v, np.ndarray) for v in ref.values())
