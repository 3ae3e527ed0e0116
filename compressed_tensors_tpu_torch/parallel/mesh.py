"""Process mesh and tensor/expert-parallel sharding of compressed Llama
params over ``torch.distributed``.

Counterpart of ``compressed_tensors_tpu/parallel/mesh.py``. The JAX package
places global arrays with NamedShardings and GSPMD inserts the
collectives; here a rank's params are plain tensors holding only its slice
and the forward calls the collectives itself (``models/llama.py`` through
``row_parallel_matmul``, ``ModelShard.embed`` and ``ModelShard.logits``;
``models/moe.py`` for the expert combine).

Layout (megatron-style, the JAX package's ``_qt_specs``): q/k/v/gate/up
shard their output rows, o/down their input columns (an all-reduce over
"tp" after them), embed and lm_head the vocabulary (a masked lookup plus an
all-reduce, and an all-gather of the logits), stacked experts their expert
axis over "ep", then the same split over "tp". Each checkpoint-layout leaf
is sliced on its own logical dimension and replicated per dimension where
the axis does not divide it (``_sanitize_spec``), exactly as the JAX
package shards it. The kernel layouts (``ops/linear.py``) are sliced on
their own dimensions once, at shard time.

Where the JAX package shards a fused ``qkv_proj``/``gate_up_proj`` as one
block and lets GSPMD reshard, an explicit split must give every rank its
own heads: each member is sharded and the members re-fused per rank
(``qkv_splits``/``gate_up_split`` become local). A column/row pair is
sharded whole or not at all: attention shards only where both head counts
divide "tp" and every layer's projections split into whole groups and
packed words, the MLP per layer on the same terms; otherwise that block is
replicated and runs whole on every rank.

Data parallelism replicates the params over "dp" and splits the batch:
a caller hands each rank its block of rows (``dp_rows``, where GSPMD
splits ``P("dp")``), the dense cache holds that block
(``shard_kv_cache``), and the one collective of the forward over "dp" is
a MoE layer's gather of every row's top-k experts, so that capacity is
counted over the global batch (``models/moe.py``). The serving engine's
own dp collectives are in ``engine/serving.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from compressed_tensors_tpu_torch.ops.linear import (
    QuantizedTensor,
    prepare_for_kernels,
    quantized_matmul,
)
from compressed_tensors_tpu_torch.quantization import QuantizationStrategy
from compressed_tensors_tpu_torch.utils.safetensors_io import CheckpointReader

__all__ = ["AXES", "Mesh", "make_mesh", "shard_llama_params",
           "llama_param_specs", "shard_kv_cache", "shard_tensor", "dp_rows",
           "LayerShard", "ModelShard", "row_parallel_matmul",
           "row_parallel_input", "local_config"]

# mesh axes, outer to inner (the JAX package's order: tp innermost)
AXES = ("dp", "pp", "sp", "ep", "tp")

# zero columns appended to a K-sharded W8A8 weight (the kernel takes K in
# multiples of 16); the input's first appended column carries the row's
# absmax over every shard
_W8_PAD = 16


@dataclasses.dataclass(eq=False)
class Mesh:
    """The five axis sizes, this process's coordinates on them, one
    process group per axis of size > 1 (the ranks along that axis through
    this process) and the device this process computes on."""

    shape: dict
    rank: int
    coords: Optional[dict]
    group_ranks: dict
    groups: dict
    device: torch.device

    @property
    def size(self) -> int:
        return int(np.prod([self.shape[a] for a in AXES]))

    def index(self, axis: str) -> int:
        return self.coords[axis] if self.coords is not None else 0

    def group(self, axis: str):
        """The process group of ``axis``; raises where the mesh was built
        without one (no ``init_dist`` before ``make_mesh``)."""
        group = self.groups.get(axis)
        if group is None:
            raise RuntimeError(
                f"mesh axis {axis!r} of size {self.shape[axis]} has no "
                "process group: open one with init_dist before make_mesh")
        return group

    def require_groups(self) -> None:
        for axis in AXES:
            if self.shape[axis] > 1:
                self.group(axis)

    def all_reduce(self, t: torch.Tensor, axis: str = "tp",
                   op: str = "sum") -> torch.Tensor:
        """In-place all-reduce of ``t`` over ``axis`` (sum or max)."""
        if self.shape[axis] == 1:
            return t
        dist.all_reduce(t, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=self.group(axis))
        return t

    def all_gather(self, t: torch.Tensor, axis: str = "tp",
                   dim: int = -1) -> torch.Tensor:
        """The shards of ``t`` over ``axis``, concatenated along ``dim`` in
        rank order."""
        if self.shape[axis] == 1:
            return t
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(self.shape[axis])]
        dist.all_gather(parts, t, group=self.group(axis))
        return torch.cat(parts, dim=dim)

    def broadcast(self, t: torch.Tensor, axis: str, index: int
                  ) -> torch.Tensor:
        """In-place broadcast of ``t`` from the rank at ``index`` of this
        rank's ``axis`` line to the whole line."""
        if self.shape[axis] == 1:
            return t
        dist.broadcast(t, self.group_ranks[axis][index],
                       group=self.group(axis))
        return t


def make_mesh(dp: int = 1, tp: int = 1, pp: int = 1, ep: int = 1,
              sp: int = 1, device="cuda", rank: int | None = None,
              world: int | None = None) -> Mesh:
    """A mesh over the default group's first dp*pp*sp*ep*tp ranks, laid
    out as ``reshape(dp, pp, sp, ep, tp)`` (tp innermost, as in the JAX
    package).

    Every rank must call it, in the same order as its other group
    creations: it opens one process group per axis line of size > 1, all
    of them on every rank. A mesh of one process needs no group. ``rank``
    and ``world`` name a process of a mesh without opening any group (to
    compute that rank's shards in one process); a forward over such a mesh
    raises at its first collective.

    :raises ValueError: when the world is smaller than the mesh
    """
    from compressed_tensors_tpu_torch.models.llama import resolve_device

    sizes = dict(dp=dp, pp=pp, sp=sp, ep=ep, tp=tp)
    n = int(np.prod(list(sizes.values())))
    live = dist.is_available() and dist.is_initialized()
    explicit = rank is not None or world is not None
    if world is None:
        world = dist.get_world_size() if live else 1
    if rank is None:
        rank = dist.get_rank() if live else 0
    if world < n:
        raise ValueError(f"need {n} processes, have {world}")
    layout = np.arange(n).reshape([sizes[a] for a in AXES])
    coords = (dict(zip(AXES, (int(c) for c in np.unravel_index(
        rank, layout.shape)))) if rank < n else None)
    group_ranks, groups = {}, {}
    for i, axis in enumerate(AXES):
        lines = np.moveaxis(layout, i, -1).reshape(-1, sizes[axis])
        for line in lines.tolist():
            if rank in line:
                group_ranks[axis] = line
        if sizes[axis] > 1 and live and not explicit:
            for line in lines.tolist():
                # every rank creates every group, in this order
                group = dist.new_group(line)
                if rank in line:
                    groups[axis] = group
    return Mesh(shape=sizes, rank=rank, coords=coords,
                group_ranks=group_ranks, groups=groups,
                device=resolve_device(device))


# role -> which logical weight dim is tp-sharded (0 = out features / rows,
# 1 = in features / cols, None = replicated)
_ROLE_SHARD_DIM = {
    "q_proj": 0, "k_proj": 0, "v_proj": 0, "gate_proj": 0, "up_proj": 0,
    "o_proj": 1, "down_proj": 1, "lm_head": 0,
    "qkv_proj": 0, "gate_up_proj": 0,
}


def _qt_specs(role: str) -> dict:
    """The JAX package's PartitionSpecs of each checkpoint-layout leaf of a
    QuantizedTensor by role, as tuples of axis names (None: replicated)."""
    if role.startswith("experts."):
        dim = _ROLE_SHARD_DIM.get(role.split(".", 1)[1])
        if dim is None:
            return {}
        main = ("ep", "tp", None) if dim == 0 else ("ep", None, "tp")
        return {
            "weight": main, "weight_packed": main, "scale": main,
            "zero_point": main,
            "bias": ("ep", "tp") if dim == 0 else ("ep", None),
            "g_idx": ("ep", None) if dim == 0 else ("ep", "tp"),
        }
    dim = _ROLE_SHARD_DIM.get(role)
    if dim is None:
        return {}
    row, col = ("tp", None), (None, "tp")
    main = row if dim == 0 else col
    specs = {"weight": main, "weight_packed": main, "scale": main,
             "zero_point": main, "sparse_values": main,
             "sparse_bitmask": main}
    if dim == 0:
        specs["bias"] = ("tp",)
    else:
        specs["bias"] = (None,)
        specs["g_idx"] = ("tp",)
    return specs


def llama_param_specs(role: str) -> dict:
    """PartitionSpec tuples of a role's checkpoint-layout leaves."""
    return _qt_specs(role)


def _sanitize_spec(shape, spec, mesh: Mesh) -> tuple:
    """Drop spec axes that don't divide the tensor dim (per-dim fallback,
    as in the JAX package)."""
    out = []
    for d, axis in enumerate(spec):
        if axis is None or d >= len(shape):
            out.append(None)
            continue
        out.append(axis if shape[d] % mesh.shape[axis] == 0 else None)
    return tuple(out)


def _slice_ranges(shape, spec, mesh: Mesh) -> list:
    """(start, stop) per dim of this rank's block under ``spec``."""
    spec = _sanitize_spec(shape, spec, mesh)
    out = []
    for d, size in enumerate(shape):
        axis = spec[d] if d < len(spec) else None
        if axis is None:
            out.append((0, size))
        else:
            part = size // mesh.shape[axis]
            i = mesh.index(axis)
            out.append((i * part, (i + 1) * part))
    return out


def shard_tensor(t: torch.Tensor, spec, mesh: Mesh) -> torch.Tensor:
    """This rank's block of ``t`` under ``spec`` (sanitized), a contiguous
    tensor of its own; ``t`` itself where nothing is sharded."""
    ranges = _slice_ranges(tuple(t.shape), spec, mesh)
    if all(r == (0, s) for r, s in zip(ranges, t.shape)):
        return t
    for d, (a, b) in enumerate(ranges):
        t = t.narrow(d, a, b - a)
    return t.clone(memory_format=torch.contiguous_format)


# --------------------------------------------------------------------------- #
# what splits


def _group_size(qt: QuantizedTensor) -> int | None:
    args = qt.scheme.weights if qt.scheme is not None else None
    if args is not None and args.strategy in (
            QuantizationStrategy.GROUP.value,
            QuantizationStrategy.TENSOR_GROUP.value):
        return args.group_size
    return None


def _dynamic_8bit(qt: QuantizedTensor) -> bool:
    """Whether the linear quantizes its input per token (W8A8 int or fp8
    with dynamic activations): its row absmax must span every K shard."""
    acts = qt.scheme.input_activations if qt.scheme is not None else None
    return (acts is not None and acts.dynamic is True
            and acts.num_bits == 8 and qt.weight is not None)


def _dim_ok(qt: QuantizedTensor, dim: int, parts: int) -> bool:
    """Whether ``qt``'s rows (dim -2) or columns (dim -1) split into
    ``parts`` blocks that every layout of it can take: whole groups and
    packed words along K, whole packed zero-point words along N, K in
    multiples of 16 for the W8A8 kernel. A K split of an actorder weight
    needs its permuted int4/int8 kernel layout."""
    if parts == 1:
        return True
    size = qt.shape[dim]
    if size % parts:
        return False
    local = size // parts
    kind = qt.kernel_meta[0] if qt.kernel_meta is not None else None
    if dim == -1:
        g = _group_size(qt)
        if g and local % g:
            return False
        if (qt.weight_packed is not None or qt.sparse_values is not None
                or kind is not None) and local % 32:
            return False
        if qt.g_idx is not None and (kind not in ("w4a16", "w4e8")):
            return False
        if kind == "w4packed" and qt.kernel_perm is not None:
            return False
        if _dynamic_8bit(qt) and local % _W8_PAD:
            return False
    else:
        zp = qt.zero_point
        if zp is not None and zp.dtype == torch.int32 and local % 8:
            return False
    return True


# --------------------------------------------------------------------------- #
# slicing a QuantizedTensor


def _local_index(sizes, parts: int, i: int, unit: int, device):
    """Indices of rank ``i``'s rows of a fused dim whose members have
    ``sizes`` logical rows, ``unit`` logical rows an element."""
    idx, start = [], 0
    for size in sizes:
        part = size // parts // unit
        a = start // unit + i * part
        idx.append(torch.arange(a, a + part, device=device))
        start += size
    return torch.cat(idx)


def _kernel_axes(qt: QuantizedTensor) -> dict:
    """field -> (N axis, K axis, logical K columns an element) of the
    kernel layout, on its last two dims (stacked experts add a leading
    one)."""
    kind, g = qt.kernel_meta[0], qt.kernel_meta[3] if len(
        qt.kernel_meta) > 3 else None
    if kind == "w8a8":
        return {"kernel_packed": (-2, -1, 1), "kernel_scales": (-1, None, 1)}
    if kind == "w4packed":
        return {"kernel_packed": (-1, -2, 8), "kernel_scales": (-1, -2, g),
                "kernel_zp": (-1, -2, g)}
    unit = {"w4a16": 8, "w4e8": 1, "fp4": 2}[kind]
    return {"kernel_packed": (-2, -1, unit), "kernel_scales": (-1, -2, g),
            "kernel_zp": (-1, -2, g)}


def _shard_qt(qt: QuantizedTensor, role: str, mesh: Mesh,
              members=None) -> QuantizedTensor:
    """This rank's QuantizedTensor for ``role``: checkpoint leaves by the
    JAX package's specs (``members``: a fused tensor's member row counts,
    each sharded on its own), kernel layouts on their own dims, the shape
    and kernel meta local. A K-sharded kernel layout that can quantize
    its input rows gains zero columns (``_pad_k``, see
    ``row_parallel_input``)."""
    specs = _qt_specs(role)
    experts = role.startswith("experts.")
    dim = _ROLE_SHARD_DIM.get(role.split(".", 1)[-1] if experts else role)
    tp, r = mesh.shape["tp"], mesh.index("tp")
    shape = list(qt.shape)
    rep: dict[str, Any] = {}
    ep_idx = None
    if experts and shape[0] % mesh.shape["ep"] == 0 and mesh.shape["ep"] > 1:
        e = shape[0] // mesh.shape["ep"]
        ep_idx = torch.arange(mesh.index("ep") * e,
                              (mesh.index("ep") + 1) * e)
        shape[0] = e
    nd = len(shape)
    tp_dim = None if dim is None else (nd - 2 if dim == 0 else nd - 1)
    split_tp = (tp > 1 and tp_dim is not None
                and _dim_ok(qt, tp_dim - nd, tp))

    def take(t, axis, index):
        return t.index_select(axis, index.to(t.device))

    for fname in ("weight", "weight_packed", "scale", "zero_point", "g_idx",
                  "bias", "sparse_values", "sparse_bitmask"):
        t = getattr(qt, fname)
        if t is None or fname not in specs:
            continue
        spec = _sanitize_spec(t.shape, specs[fname], mesh)
        if ep_idx is not None and spec and spec[0] == "ep":
            t = take(t, 0, ep_idx)
        if split_tp and "tp" in spec:
            axis = spec.index("tp")
            unit = qt.shape[tp_dim] // t.shape[axis] if t.shape[axis] else 1
            sizes = members if (members and tp_dim == nd - 2) else [
                qt.shape[tp_dim]]
            t = take(t, axis, _local_index(sizes, tp, r, unit, t.device))
        rep[fname] = t

    if qt.kernel_meta is not None:
        kind = qt.kernel_meta[0]
        for fname, (n_ax, k_ax, unit) in _kernel_axes(qt).items():
            t = getattr(qt, fname)
            if t is None:
                continue
            if ep_idx is not None:
                t = take(t, 0, ep_idx)
            if split_tp and tp_dim == nd - 2 and n_ax is not None:
                sizes = members or [qt.shape[tp_dim]]
                t = take(t, n_ax, _local_index(sizes, tp, r, 1, t.device))
            elif split_tp and tp_dim == nd - 1 and k_ax is not None \
                    and kind != "w4packed":
                k_local = qt.shape[-1] // tp
                t = t.narrow(k_ax, r * k_local // unit,
                             k_local // unit).clone(
                    memory_format=torch.contiguous_format)
            rep[fname] = t
        if split_tp and tp_dim == nd - 1 and qt.kernel_perm is not None:
            # actorder: the permutation crosses K shards; keep this rank's
            # part of it, which indexes the gathered input
            k_local = qt.shape[-1] // tp
            rep["kernel_perm"] = qt.kernel_perm[
                r * k_local:(r + 1) * k_local].clone()

    if split_tp:
        shape[tp_dim] //= tp
    rep["shape"] = tuple(shape)
    if qt.kernel_meta is not None:
        meta = list(qt.kernel_meta)
        meta[1], meta[2] = shape[-2], shape[-1]
        rep["kernel_meta"] = tuple(meta)
    out = dataclasses.replace(qt, **rep)
    if split_tp and tp_dim == nd - 1 and qt.kernel_meta is not None:
        out = _pad_k(out, qt.shape[-1])
    return out


# an int32 word of eight codes u = 8, the value 0 (0x88888888)
_ZERO_WORD = -2004318072


def _pad_k(qt: QuantizedTensor, k_full: int) -> QuantizedTensor:
    """A K shard's kernel layout with zero columns appended where its
    kernel can quantize each input row by the row's absmax: B3 (W8A8,
    ``_W8_PAD`` int8 zeros); the int4 words of B1 and of stacked experts
    (their a8b mode: one group of zero codes at scale 0); the plane layout
    (its a8 mode: rebuilt from the checkpoint words with one group more,
    at scale 0). ``row_parallel_input`` appends as many input columns. An
    actorder permutation gains the indices of the columns appended to the
    gathered input (``k_full`` wide). Other layouts are returned as they
    are."""
    kind = qt.kernel_meta[0]
    n, k = qt.kernel_meta[1:3]
    w = qt.kernel_packed
    if kind == "w4packed":
        g = qt.kernel_meta[3]

        def grow(t, cols):  # ``cols`` zero columns on the last dim
            return None if t is None else torch.cat(
                [t, t.new_zeros((*t.shape[:-1], cols))], dim=-1)

        padded = prepare_for_kernels(dataclasses.replace(
            qt, weight_packed=grow(qt.weight_packed, g // 8),
            scale=grow(qt.scale, 1), zero_point=grow(qt.zero_point, 1),
            shape=(n, k + g), kernel_packed=None, kernel_scales=None,
            kernel_zp=None, kernel_perm=None, kernel_meta=None),
            w4_layout="packed")
        return dataclasses.replace(qt, **{
            f: getattr(padded, f) for f in ("kernel_packed", "kernel_scales",
                                            "kernel_zp", "kernel_meta")})
    if kind == "w8a8" and _dynamic_8bit(qt):
        pad = _W8_PAD
        words = torch.zeros((*w.shape[:-1], pad), dtype=torch.int8,
                            device=w.device).view(w.dtype)
        rep = {}
    elif kind == "w4a16":
        pad = qt.kernel_meta[3]
        words = torch.full((*w.shape[:-1], pad // 8), _ZERO_WORD,
                           dtype=torch.int32, device=w.device)
        rows = torch.zeros((*qt.kernel_scales.shape[:-2], 1, n),
                           dtype=torch.float32, device=w.device)
        rep = {"kernel_scales": torch.cat([qt.kernel_scales, rows], dim=-2)}
        if qt.kernel_zp is not None:
            rep["kernel_zp"] = torch.cat([qt.kernel_zp, rows], dim=-2)
    else:
        return qt
    if qt.kernel_perm is not None:
        rep["kernel_perm"] = torch.cat([qt.kernel_perm, torch.arange(
            k_full, k_full + pad, device=qt.kernel_perm.device)])
    return dataclasses.replace(
        qt, kernel_packed=torch.cat([w, words], dim=-1).contiguous(),
        kernel_meta=(kind, n, k + pad, *qt.kernel_meta[3:]), **rep)


def _is_qt(v) -> bool:
    return isinstance(v, QuantizedTensor)


# --------------------------------------------------------------------------- #
# the sharded params


@dataclasses.dataclass(frozen=True, eq=False)
class LayerShard:
    """How one decoder layer is sharded: ``rows`` names its row-parallel
    linears (an all-reduce over "tp" follows each), ``replicated_inputs``
    those of them whose input is whole on every rank (MLA's o_proj: the
    linear takes its own slice), ``experts`` the (first expert, local
    count, tp-sharded) of a MoE block and ``shared_rows`` whether its
    shared expert is tp-sharded."""

    mesh: Mesh
    rows: frozenset = frozenset()
    replicated_inputs: frozenset = frozenset()
    experts: Optional[tuple] = None
    shared_rows: bool = False


@dataclasses.dataclass(frozen=True, eq=False)
class ModelShard:
    """The model-wide sharding: local (query, kv) head counts where
    attention is head-sharded, whether the embedding and the lm_head are
    vocabulary-sharded, and the checkpoint bytes a sharded load read."""

    mesh: Mesh
    heads: Optional[tuple] = None
    vocab_embed: bool = False
    vocab_head: bool = False
    # checkpoint bytes this rank read for its params (a sharded load)
    bytes_read: int = 0

    def local_config(self, config):
        if self.heads is None:
            return config
        return dataclasses.replace(config, num_attention_heads=self.heads[0],
                                   num_key_value_heads=self.heads[1])

    def embed(self, table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
        """Rows of a vocabulary-sharded table: a masked local lookup, then
        an all-reduce (a sum with zeros: exact)."""
        if not self.vocab_embed:
            return table[ids]
        v = table.shape[0]
        local = ids - self.mesh.index("tp") * v
        hit = (local >= 0) & (local < v)
        x = table[local.clamp(0, v - 1)]
        x = torch.where(hit[..., None], x, torch.zeros_like(x))
        return self.mesh.all_reduce(x, "tp")

    def logits(self, logits: torch.Tensor) -> torch.Tensor:
        """The full vocabulary's logits on every rank."""
        if not self.vocab_head:
            return logits
        return self.mesh.all_gather(logits, "tp", dim=-1)


def local_config(params: dict, config):
    """The config a rank's caches and attention see: local head counts
    where ``params`` are head-sharded, ``config`` otherwise."""
    shard = params.get("shard")
    return shard.local_config(config) if shard is not None else config


def _per_head(t, heads: int, mesh: Mesh):
    """A per-head scale's local heads (per-tensor ones stay)."""
    if t is None or t.numel() != heads or heads == 1:
        return t
    part = heads // mesh.shape["tp"]
    i = mesh.index("tp")
    return t.reshape(heads, *t.shape[1:])[i * part:(i + 1) * part].clone()


def dp_rows(mesh: Mesh, n: int) -> slice:
    """This rank's block of ``n`` batch rows over "dp": dp index i owns
    rows [i * n / dp, (i + 1) * n / dp), as ``P("dp")`` splits an axis.
    Where dp does not divide ``n`` every rank holds all ``n`` rows (the
    replicated fallback of ``_sanitize_spec``)."""
    dp = mesh.shape["dp"]
    if n % dp:
        return slice(0, n)
    part = n // dp
    return slice(mesh.index("dp") * part, (mesh.index("dp") + 1) * part)


def _members(layer: dict, fused: str, names) -> list:
    """(name, QuantizedTensor, member row counts or None) of a column
    group: the fused tensor with its members' sizes, or the unfused
    members."""
    if fused in layer:
        qt = layer[fused]
        if fused == "qkv_proj":
            s1, s2 = layer["qkv_splits"]
            sizes = [s1, s2 - s1, qt.shape[0] - s2]
        else:
            s = layer["gate_up_split"]
            sizes = [s, qt.shape[0] - s]
        return [(fused, qt, sizes)]
    return [(n, layer[n], None) for n in names if n in layer]


_ATTN_COLS = ("qkv_proj", ("q_proj", "k_proj", "v_proj"))
_MLP_COLS = ("gate_up_proj", ("gate_proj", "up_proj"))


def _pair_ok(cols, row, tp: int) -> bool:
    """Whether a column group and its row-parallel partner both split."""
    if not (_is_qt(row) and cols) or tp == 1:
        return False
    for _, qt, sizes in cols:
        if not _is_qt(qt) or not _dim_ok(qt, -2, tp):
            return False
        packed_zp = qt.zero_point is not None \
            and qt.zero_point.dtype == torch.int32
        if sizes and any(n % tp or (packed_zp and (n // tp) % 8)
                         for n in sizes):
            return False
    return _dim_ok(row, -1, tp)


def _attn_sharded(layers, config, tp: int) -> bool:
    """Attention is head-sharded in every layer or in none (the cache's
    kv-head axis is one for all layers)."""
    H, KVH = config.num_attention_heads, config.num_key_value_heads
    return (tp > 1 and not config.is_mla and H % tp == 0 and KVH % tp == 0
            and all(_pair_ok(_members(l, *_ATTN_COLS), l.get("o_proj"), tp)
                    for l in layers))


def _vocab_sharded(t, tp: int) -> bool:
    if _is_qt(t):
        return tp > 1 and _dim_ok(t, -2, tp)
    return tp > 1 and t.shape[0] % tp == 0


@dataclasses.dataclass(frozen=True)
class _Plan:
    """What splits over "tp", which ``shard_llama_params`` and
    ``ShardedCheckpointReader`` both follow: attention in every layer or
    in none, per layer the dense MLP pair and MLA's o_proj alone, the
    embedding and the lm_head by vocabulary."""

    attn: bool
    mlp: tuple
    mla_o: tuple
    vocab_embed: bool
    vocab_head: bool

    def layer_shard(self, i: int, mesh: Mesh, experts=None,
                    shared_rows: bool = False) -> LayerShard:
        rows = {"o_proj"} if self.attn or self.mla_o[i] else set()
        if self.mlp[i]:
            rows.add("down_proj")
        return LayerShard(mesh, frozenset(rows), frozenset(
            {"o_proj"} if self.mla_o[i] else ()), experts, shared_rows)

    def model_shard(self, mesh: Mesh, config,
                    bytes_read: int = 0) -> ModelShard:
        tp = mesh.shape["tp"]
        return ModelShard(
            mesh, heads=((config.num_attention_heads // tp,
                          config.num_key_value_heads // tp)
                         if self.attn else None),
            vocab_embed=self.vocab_embed, vocab_head=self.vocab_head,
            bytes_read=bytes_read)


def _plan(layers, config, tp: int, embed, lm_head) -> _Plan:
    """The plan of ``layers`` (dicts of QuantizedTensors, or of stubs with
    their shapes) and the embedding and lm_head (``lm_head`` None: tied)."""
    vocab_embed = _vocab_sharded(embed, tp)
    return _Plan(
        attn=_attn_sharded(layers, config, tp),
        mlp=tuple("moe" not in l and _pair_ok(
            _members(l, *_MLP_COLS), l.get("down_proj"), tp) for l in layers),
        mla_o=tuple(config.is_mla and tp > 1 and _is_qt(l.get("o_proj"))
                    and _dim_ok(l["o_proj"], -1, tp) for l in layers),
        vocab_embed=vocab_embed,
        vocab_head=(vocab_embed if lm_head is None
                    else _vocab_sharded(lm_head, tp)))


def shard_llama_params(params: dict, mesh: Mesh, config) -> dict:
    """This rank's params of ``params`` (full, on every rank) over
    ``mesh``: tp and ep split as the module docstring says; dp, pp and sp
    replicate (``pipeline.stack_stage_params`` splits the layers over pp;
    sp is only named, as in the JAX package). Under dp > 1 the params
    carry the mesh even where nothing splits: a MoE layer gathers its
    routing over "dp" when the forward's rows are the rank's dp block
    (``llama_forward(dp_block=True)``). A mesh that splits nothing else
    returns ``params`` itself, so the forward is the unsharded one."""
    tp, ep = mesh.shape["tp"], mesh.shape["ep"]
    if tp == 1 and ep == 1 and mesh.shape["dp"] == 1:
        return params
    if params.get("shard") is not None:
        raise ValueError("params are already sharded")
    layers = params["layers"]
    H, KVH = config.num_attention_heads, config.num_key_value_heads
    emb, lm = params["embed_tokens"], params["lm_head"]
    plan = _plan(layers, config, tp, emb, None if lm is emb else lm)
    out: dict = {k: v for k, v in params.items() if k != "layers"}
    if plan.vocab_embed:
        out["embed_tokens"] = shard_tensor(emb, ("tp", None), mesh)
    if lm is emb:
        out["lm_head"] = out["embed_tokens"]
    elif plan.vocab_head:
        out["lm_head"] = (_shard_qt(lm, "lm_head", mesh) if _is_qt(lm)
                          else shard_tensor(lm, ("tp", None), mesh))

    out["layers"] = []
    for i, layer in enumerate(layers):
        new = dict(layer)
        if plan.attn:
            for name, qt, sizes in _members(layer, *_ATTN_COLS):
                new[name] = _shard_qt(qt, name, mesh, members=sizes)
            if "qkv_splits" in layer:
                s1, s2 = layer["qkv_splits"]
                new["qkv_splits"] = (s1 // tp, s2 // tp)
            new["o_proj"] = _shard_qt(layer["o_proj"], "o_proj", mesh)
            for key, heads in (("q_scale", H), ("k_scale", KVH),
                               ("v_scale", KVH)):
                if layer.get(key) is not None:
                    new[key] = _per_head(layer[key], heads, mesh)
        elif plan.mla_o[i]:
            # MLA: only o_proj is sharded; its input is whole everywhere
            new["o_proj"] = _shard_qt(layer["o_proj"], "o_proj", mesh)
        experts, shared_rows = None, False
        if "moe" in layer:
            moe = layer["moe"]
            ex = moe["experts"]
            E = ex["gate_proj"].shape[0]
            e_local = E // ep if E % ep == 0 else E
            ex_tp = tp > 1 and all(_dim_ok(ex[n], -2, tp)
                                   for n in ("gate_proj", "up_proj")) \
                and _dim_ok(ex["down_proj"], -1, tp)
            sub = mesh if ex_tp else dataclasses.replace(
                mesh, shape=dict(mesh.shape, tp=1))
            new_moe = dict(moe)
            new_moe["experts"] = {n: _shard_qt(qt, f"experts.{n}", sub)
                                  for n, qt in ex.items()}
            experts = ((mesh.index("ep") * e_local if E % ep == 0 else 0),
                       e_local, ex_tp)
            shared = moe.get("shared_expert")
            if shared is not None and _pair_ok(
                    [(n, shared[n], None) for n in ("gate_proj", "up_proj")],
                    shared["down_proj"], tp):
                new_moe["shared_expert"] = {
                    n: _shard_qt(qt, n, mesh) for n, qt in shared.items()}
                shared_rows = True
            new["moe"] = new_moe
        elif plan.mlp[i]:
            for name, qt, sizes in _members(layer, *_MLP_COLS):
                new[name] = _shard_qt(qt, name, mesh, members=sizes)
            if "gate_up_split" in layer:
                new["gate_up_split"] = layer["gate_up_split"] // tp
            new["down_proj"] = _shard_qt(layer["down_proj"], "down_proj",
                                         mesh)
        new["shard"] = plan.layer_shard(i, mesh, experts, shared_rows)
        out["layers"].append(new)
    out["shard"] = plan.model_shard(mesh, config)
    return out


def shard_kv_cache(cache, mesh: Mesh):
    """This rank's block of a dense or paged KV cache, as the JAX package
    shards it: the KV-head axis over "tp" (the pool of a head-sharded
    model) and, for the dense cache only, the batch axis over "dp"; each
    axis replicated where it does not divide. The paged pool stays whole
    over dp, and tables and lengths stay whole, so the host-side slot and
    page bookkeeping is the same on every rank."""
    from compressed_tensors_tpu_torch.models.llama import PagedKVCache

    spec = (None, None if isinstance(cache, PagedKVCache) else "dp", "tp",
            None, None)
    return dataclasses.replace(cache, k=shard_tensor(cache.k, spec, mesh),
                               v=shard_tensor(cache.v, spec, mesh))


# --------------------------------------------------------------------------- #
# row-parallel linears


def _runs_kernel(x: torch.Tensor, qt: QuantizedTensor,
                 use_kernels: bool) -> bool:
    """Whether ``quantized_matmul`` (or ``quantized_matmul_experts``) runs
    ``qt``'s kernel layout on ``x``: not on the non-kernel path, nor where
    the ``w4_dense_m`` opt-in dequantizes a 4-bit weight instead."""
    from compressed_tensors_tpu_torch.flags import kernels_enabled
    from compressed_tensors_tpu_torch.ops.linear import _dense_above

    if not (kernels_enabled(use_kernels) and qt.kernel_meta is not None):
        return False
    return not (len(qt.shape) == 2 and qt.weight_packed is not None
                and qt.kernel_meta[0] in ("w4a16", "w4packed", "w4e8")
                and _dense_above(x.numel() // x.shape[-1]))


def _quantizes_rows(x: torch.Tensor, qt: QuantizedTensor) -> bool:
    """Whether the kernel call on ``x`` quantizes each input row by its
    absmax: B3 always, the int4 words in their a8b mode (which
    ``_w4b8_mode`` picks from the rows, per expert for stacked experts,
    and the local shape), the plane layout in its a8 mode."""
    from compressed_tensors_tpu_torch.ops.linear import _w4_mode, _w4b8_mode

    kind, n, k = qt.kernel_meta[:3]
    if kind == "w8a8":
        return True
    if kind == "w4a16":
        rows = (x.shape[-2] if len(qt.shape) == 3
                else x.numel() // x.shape[-1])
        return _w4b8_mode(rows, n, k) == "a8b"
    return kind == "w4packed" and _w4_mode() == "a8"


def row_parallel_input(x: torch.Tensor, qt: QuantizedTensor, mesh: Mesh,
                       replicated: bool = False, use_kernels: bool = True,
                       amax: torch.Tensor | None = None) -> torch.Tensor:
    """The input a rank's K-sharded linear takes: its own slice of a
    replicated input; the gathered input where an actorder permutation
    crosses the shards; where the kernel layout is padded (``_pad_k``),
    x with the padding's columns appended. They are zeros, but where the
    call quantizes its rows (``_quantizes_rows``) the first holds each
    row's absmax over every shard (an all-reduce MAX, or ``amax`` (..., 1)
    where the caller has it), so that the kernel takes the unsharded
    per-token scale. The padding adds nothing to the product."""
    r = mesh.index("tp")
    kernel = _runs_kernel(x, qt, use_kernels)
    k_local = qt.shape[-1]
    if kernel and qt.kernel_perm is not None:
        # the permutation indexes the whole row: gather it
        if not replicated:
            x = mesh.all_gather(x, "tp", dim=-1)
    elif replicated:
        x = x[..., r * k_local:(r + 1) * k_local]
    pad = qt.kernel_meta[2] - k_local if kernel else 0
    if pad:
        cols = x.new_zeros((*x.shape[:-1], pad))
        if _quantizes_rows(x, qt):
            if amax is None:
                amax = _row_absmax(x, mesh)
            cols[..., :1] = amax.to(x.dtype)
        x = torch.cat([x, cols], dim=-1)
    return x


def _row_absmax(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    amax = x.to(torch.float32).abs().amax(dim=-1, keepdim=True)
    return mesh.all_reduce(amax, "tp", op="max")


def _w8_whole_rows(qt: QuantizedTensor) -> bool:
    """Whether the non-kernel path quantizes ``qt``'s input per token (the
    W8A8 products of ``quantized_matmul`` and its expert form)."""
    return _dynamic_8bit(qt) and qt.scheme.weights.strategy in (
        QuantizationStrategy.CHANNEL.value, QuantizationStrategy.TENSOR.value)


def _w8_matmul_global(x, qt: QuantizedTensor, mesh: Mesh) -> torch.Tensor:
    """The non-kernel W8A8 product of a K shard (stacked experts: of each
    expert's) with the row scale of the whole row (the JAX package's
    ``_int8_dynamic_matmul`` / ``_fp8_matmul`` arithmetic)."""
    from compressed_tensors_tpu_torch.ops.qparams import (
        compute_dynamic_scales_and_zp,
    )
    from compressed_tensors_tpu_torch.ops.quantize import quantize

    args = qt.scheme.input_activations
    amax = _row_absmax(x, mesh).to(x.dtype)
    x_scale, _ = compute_dynamic_scales_and_zp(torch.cat([x, amax], -1), args)
    w = qt.weight
    w_scale = qt.scale.to(torch.float32).reshape(*w.shape[:-2], 1, -1)
    if w.dtype == torch.int8:
        x_q = quantize(x, x_scale, None, args, dtype=torch.int8)
        acc = torch.matmul(x_q.to(torch.float64),
                           w.to(torch.float64).transpose(-1, -2)).to(
            torch.float32)
    else:
        x_q = quantize(x, x_scale, None, args, dtype=w.dtype)
        acc = torch.matmul(x_q.to(torch.float32),
                           w.to(torch.float32).transpose(-1, -2))
    return (acc * x_scale.to(torch.float32) * w_scale).to(x.dtype)


def row_parallel_matmul(x: torch.Tensor, qt: QuantizedTensor, mesh: Mesh,
                        replicated: bool = False,
                        use_kernels: bool = True) -> torch.Tensor:
    """y = x @ W^T for a K-sharded W: this rank's partial product (the
    kernels as in ``quantized_matmul``) summed over "tp" in f32; a bias is
    added once, after the sum."""
    bias = qt.bias
    if bias is not None:
        qt = dataclasses.replace(qt, bias=None)
    kernel = _runs_kernel(x, qt, use_kernels)
    if not kernel and _w8_whole_rows(qt):
        if replicated:
            k = qt.shape[-1]
            r = mesh.index("tp")
            x = x[..., r * k:(r + 1) * k]
        out = _w8_matmul_global(x, qt, mesh)
    else:
        if qt.g_idx is not None and not kernel:
            raise NotImplementedError(
                "a K-sharded actorder linear runs on its kernel layout only")
        out = quantized_matmul(
            row_parallel_input(x, qt, mesh, replicated, use_kernels), qt,
            use_kernels)
    partial = out.to(torch.float32)
    out = mesh.all_reduce(partial, "tp").to(out.dtype)
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def row_parallel_experts(x: torch.Tensor, qt: QuantizedTensor, mesh: Mesh,
                         use_kernels: bool = True) -> torch.Tensor:
    """This rank's partial product of K-sharded stacked experts on their
    (E, C, K/tp) input, as ``quantized_matmul_experts`` computes it whole:
    a padded layout takes ``row_parallel_input``'s columns, W8A8 experts
    quantize by the whole row's scale (and, as there, add no bias), and a
    bias is added on tp rank 0 only. ``moe_mlp``'s combine sums the
    partials over "tp"."""
    from compressed_tensors_tpu_torch.ops.linear import (
        quantized_matmul_experts,
    )

    if not _runs_kernel(x, qt, use_kernels) and _w8_whole_rows(qt):
        return _w8_matmul_global(x, qt, mesh)
    bias = qt.bias
    if bias is not None:
        qt = dataclasses.replace(qt, bias=None)
    out = quantized_matmul_experts(
        row_parallel_input(x, qt, mesh, use_kernels=use_kernels), qt,
        use_kernels)
    if bias is not None and mesh.index("tp") == 0:
        out = out + bias.to(out.dtype)[:, None, :]
    return out


# --------------------------------------------------------------------------- #
# loading a rank's blocks of a checkpoint

# checkpoint local name -> QuantizedTensor field
_CKPT_FIELDS = {"weight": "weight", "weight_packed": "weight_packed",
                "weight_scale": "scale", "weight_zero_point": "zero_point",
                "weight_g_idx": "g_idx", "bias": "bias",
                "weight.compressed": "sparse_values",
                "weight.bitmask": "sparse_bitmask"}


class ShardedCheckpointReader(CheckpointReader):
    """A ``CheckpointReader`` that hands out this rank's blocks: every
    tensor of a sharded module is read as its block only, by
    ``offload.load.read_block`` (``load_sharded_params``' slicer) under
    the specs ``shardings`` holds, which ``shard_llama_params`` would
    give it (the same ``_Plan``), and a module's ``weight_shape`` is its
    local shape. ``load_llama_params(mesh=...)`` reads through it and
    ``finish`` marks the params it built as sharded. Dense GQA models
    without actorder only: other checkpoints load whole, then
    ``shard_llama_params``."""

    def __init__(self, path: str, config, schemes: dict, mesh: Mesh):
        from compressed_tensors_tpu_torch.flags import FLAGS
        from compressed_tensors_tpu_torch.ops.linear import (
            from_compressed_state,
        )

        if config.is_mla or config.is_moe:
            raise NotImplementedError(
                "sharded loading of MoE and MLA checkpoints: load them whole "
                "and shard them with shard_llama_params")
        super().__init__(path)
        self.mesh, self.config = mesh, config
        self.bytes_read = 0
        tp = mesh.shape["tp"]
        names = self.tensor_names()
        if any(self.split(n)[1] == "weight_g_idx" for n in names):
            raise NotImplementedError(
                "an actorder linear is sharded from its kernel layout: load "
                "the checkpoint whole, then shard_llama_params")

        def stub(module):
            """The module's QuantizedTensor with meta tensors (shapes and
            dtypes only) and its real ``weight_shape``."""
            state = {}
            for name in names:
                mod, local = self.split(name)
                if mod == module:
                    state[local] = (
                        CheckpointReader.get(self, name)
                        if local in ("weight_shape", "weight.shape")
                        else torch.empty(self.get_shape(name),
                                         dtype=self.get_dtype(name),
                                         device="meta"))
            return from_compressed_state(state, schemes.get(module))

        layers = []
        for i in range(config.num_hidden_layers):
            p = f"model.layers.{i}"
            layers.append({n: stub(f"{p}.self_attn.{n}") for n in
                           ("q_proj", "k_proj", "v_proj", "o_proj")}
                          | {n: stub(f"{p}.mlp.{n}") for n in
                             ("gate_proj", "up_proj", "down_proj")})
        modules = self.module_names()
        self.plan = _plan(layers, config, tp, stub("model.embed_tokens"),
                          stub("lm_head") if "lm_head" in modules else None)
        roles = {}   # sharded module -> role
        if self.plan.vocab_embed:
            roles["model.embed_tokens"] = "lm_head"
        if self.plan.vocab_head and "lm_head" in modules:
            roles["lm_head"] = "lm_head"
        for i, layer in enumerate(layers):
            p = f"model.layers.{i}"
            for sub, role in ([("self_attn", n) for n in (
                    "q_proj", "k_proj", "v_proj", "o_proj")]
                    if self.plan.attn else []) + (
                    [("mlp", n) for n in ("gate_proj", "up_proj",
                                          "down_proj")]
                    if self.plan.mlp[i] else []):
                qt = layer[role]
                if (role in ("o_proj", "down_proj") and qt.weight is not None
                        and qt.weight.dtype == torch.float8_e4m3fn
                        and FLAGS.fp8_transcode == "always"):
                    raise NotImplementedError(
                        "fp8_transcode re-grids each channel over the whole "
                        "row: load whole, then shard_llama_params")
                roles[f"{p}.{sub}.{role}"] = role
        self.roles = roles
        # tensor name -> spec of every tensor read as a block
        self.shardings: dict[str, tuple] = {}
        for name in names:
            module, local = self.split(name)
            spec = None
            if module in roles:
                spec = _qt_specs(roles[module]).get(_CKPT_FIELDS.get(local))
            elif self.plan.attn and local in ("k_scale", "v_scale",
                                              "q_scale"):
                shape = self.get_shape(name)
                heads = (config.num_attention_heads if local == "q_scale"
                         else config.num_key_value_heads)
                if shape and shape[0] == heads and heads > 1:
                    spec = ("tp",) + (None,) * (len(shape) - 1)
            if spec is not None:
                self.shardings[name] = spec

    def get(self, name: str) -> torch.Tensor:
        from compressed_tensors_tpu_torch.offload.load import read_block

        module, local = self.split(name)
        if module in self.roles and local in ("weight_shape", "weight.shape"):
            t = CheckpointReader.get(self, name)
            shape = t.tolist()
            shape[_ROLE_SHARD_DIM[self.roles[module]]] //= self.mesh.shape[
                "tp"]
            return torch.tensor(shape, dtype=t.dtype)
        t, n = read_block(self, name, self.shardings.get(name), self.mesh)
        self.bytes_read += n
        return t

    def finish(self, params: dict) -> dict:
        """Mark the params built from this reader's blocks as sharded, as
        ``shard_llama_params`` marks its own: each layer's row-parallel
        linears (a padded kernel layout, ``_pad_k``), the local heads and
        the vocabulary split."""
        tp = self.mesh.shape["tp"]
        for i, layer in enumerate(params["layers"]):
            shard = self.plan.layer_shard(i, self.mesh)
            for name in shard.rows:
                qt = layer[name]
                if qt.kernel_meta is not None:
                    layer[name] = _pad_k(qt, qt.shape[-1] * tp)
            layer["shard"] = shard
        params["shard"] = self.plan.model_shard(self.mesh, self.config,
                                                self.bytes_read)
        return params
