"""The kernels' dispatch for DTensor operands (a model sharded by
``launch.steps.shard_model``).

A kernel runs on local shards: each operand is redistributed to the
placements the kernel can take (batch or head/channel shards; anything
else is gathered), handed over as its local tensor, and the kernel's
output is wrapped back into a DTensor on the same mesh. The local call goes
back through ``kernels.ops``, so a CUDA shard reaches the hand-written
kernel (never the plain version) and a CPU shard the plain version; a
DTensor never reaches a ctypes launch.

Autograd crosses the boundary: an operand that stays whole on a mesh dim
over which the computation is split (k and v under head sharding, B and C
under channel sharding, the scan's A under batch sharding) gets a partial
gradient on each rank, so its local tensor is taken with a ``Partial``
gradient placement there, and the redistribution's backward sums it
(reduce-scatter or all-reduce).

Head sharding and GQA: query head h reads kv head h % HK (the reference's
grouping and the kernels'), which contiguous head shards break (H 4 and
HK 2 on a model axis of 2: rank 0 holds q heads 0 and 1, which read kv
heads 0 and 1). So k and v are gathered whole over the head-sharding mesh
dims, and each rank picks the kv heads its q heads read, in the kernel's
grouping.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard


def local_slice(shape, mesh, placements):
    """(local shape, global offset) of this rank's shard of a tensor of
    ``shape`` under ``placements``, with ``torch.chunk``'s split (what
    DTensor's ``Shard`` takes), mesh dims applied in order. Plain integer
    arithmetic, so it also holds under ``FakeTensorMode``."""
    shape, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for n, c, p in zip(mesh.shape, coord, placements):
        if isinstance(p, Shard):
            size = shape[p.dim]
            chunk = -(-size // n)
            start = min(c * chunk, size)
            offset[p.dim] += start
            shape[p.dim] = max(0, min(chunk, size - start))
    return tuple(shape), tuple(offset)


def is_dtensor(t) -> bool:
    return isinstance(t, DTensor)


def _as_dtensor(t, mesh) -> DTensor:
    """A plain tensor counts as replicated over ``mesh``."""
    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def _keep(placements, dims) -> tuple:
    """Each ``Shard(d)`` with d in ``dims`` kept, every other placement
    (another shard, a partial sum) made ``Replicate``."""
    return tuple(p if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _map(placements, dims: dict) -> tuple:
    """``Shard(d)`` -> ``Shard(dims[d])`` (``Replicate`` where d is not in
    ``dims``); ``Replicate`` stays."""
    return tuple(Shard(dims[p.dim]) if isinstance(p, Shard) and p.dim in dims else Replicate()
                 for p in placements)


def _settle(x: DTensor) -> DTensor:
    """x with its pending sums taken (each ``Partial`` placement made
    ``Replicate``), shards kept: for a result read more than once, as an
    embedding lookup over vocabulary shards is."""
    want = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(x.device_mesh, want)


def split_last(x, *sizes):
    """``x.view(*x.shape[:-1], *sizes)``. A DTensor whose last dim is split
    over mesh dims that do not divide ``sizes[0]`` (qwen2's 14 heads of a
    896-wide projection on a 16-wide model axis) is gathered over those
    dims first; DTensor cannot unflatten an uneven split."""
    if isinstance(x, DTensor):
        last = x.dim() - 1
        ways = 1
        for n, p in zip(x.device_mesh.shape, x.placements):
            if isinstance(p, Shard) and p.dim == last:
                ways *= n
        if sizes[0] % ways:
            x = x.redistribute(x.device_mesh, tuple(
                Replicate() if isinstance(p, Shard) and p.dim == last else p
                for p in x.placements))
    return x.view(*x.shape[:-1], *sizes)


def local_call(fn: Callable, operands: Sequence, targets: Sequence[tuple],
               out_placements: Sequence[tuple]):
    """``fn`` on the local tensors of ``operands``, each redistributed to its
    ``targets`` placements first; its outputs (a tensor or a tuple) wrapped
    as DTensors with ``out_placements``. Returns a tuple of DTensors."""
    mesh = next(t for t in operands if isinstance(t, DTensor)).device_mesh
    split = [any(isinstance(tg[i], Shard) for tg in targets) for i in range(mesh.ndim)]
    local = []
    for t, tg in zip(operands, targets):
        t = _as_dtensor(t, mesh)
        if tuple(t.placements) != tuple(tg):
            t = t.redistribute(mesh, tg)
        grad = tuple(Partial() if s and isinstance(p, Replicate) else p
                     for s, p in zip(split, tg))
        local.append(t.to_local(grad_placements=grad))
    outs = fn(*local)
    outs = outs if isinstance(outs, tuple) else (outs,)
    # a partial output's gradient arrives whole (replicated) on every rank,
    # and DTensor's backward keeps it so: each rank's local gradient is the
    # whole one, as the sum's gradient is
    return tuple(DTensor.from_local(o, mesh, pl, run_check=False)
                 for o, pl in zip(outs, out_placements))


def _head_slice(q: DTensor, placements) -> tuple:
    """(first global head, local heads) of dim 1 of ``q`` under
    ``placements``."""
    shape, offset = local_slice(q.shape, q.device_mesh, placements)
    return offset[1], shape[1]


def group_kv(k: torch.Tensor, v: torch.Tensor, h0: int, hl: int):
    """The kv heads (dim 1) that q heads h0 .. h0 + hl - 1 read, arranged
    so that local q head j reads local kv head j % HK' (the kernels'
    grouping): the HK heads rotated by h0 when HK divides hl (no copy when
    h0 % HK == 0), else one kv head per q head."""
    HK = k.shape[1]
    if hl % HK == 0:
        r = h0 % HK
        if r == 0:
            return k, v
        idx = [(r + i) % HK for i in range(HK)]
    else:
        idx = [(h0 + j) % HK for j in range(hl)]
    idx = torch.tensor(idx, device=k.device)
    return k.index_select(1, idx), v.index_select(1, idx)


def attention(q: DTensor, k, v, kernel: Callable):
    """Attention on shards, (B, H, ...) queries against (B, HK, ...) keys and
    values (a whole sequence, or one token over ring caches): q keeps its
    batch and head shards; k and v keep q's batch shards and are gathered
    whole elsewhere (a cache split over its slots included), then each rank
    picks the kv heads its q heads read (``group_kv``); ``kernel(q, k, v)``
    on local tensors. Returns a DTensor placed as q."""
    qt = _keep(q.placements, (0, 1))
    kt = _keep(qt, (0,))
    h0, hl = _head_slice(q, qt)

    def fn(ql, kl, vl):
        kl, vl = group_kv(kl, vl, h0, hl)
        return kernel(ql, kl, vl)

    return local_call(fn, (q, k, v), (qt, kt, kt), (qt,))[0]


def channel_scan(seq: Sequence, per_channel: Sequence, rows: Sequence, kernel: Callable,
                 out_dims: Sequence[dict]):
    """A scan on shards of its batch (dim 0) or channels (dim 2) of the
    (B, S, C) operands ``seq`` (placed as the first one); ``per_channel``
    operands (channels on dim 0) follow the channel shards, ``rows`` (B, S,
    N) operands the batch shards. ``out_dims[i]`` maps the first operand's
    sharded dims to output i's: {0: 0, 2: 2} for a (B, S, C) output, {0: 0,
    2: 1} for a (B, C, ...) state."""
    st = _keep(seq[0].placements, (0, 2))
    ct = _map(st, {2: 0})
    rt = _keep(st, (0,))
    n_seq, n_ch = len(seq), len(per_channel)

    def fn(*local):
        return kernel(local[:n_seq], local[n_seq:n_seq + n_ch], local[n_seq + n_ch:])

    return local_call(fn, (*seq, *per_channel, *rows),
                      (st,) * n_seq + (ct,) * n_ch + (rt,) * len(rows),
                      tuple(_map(st, d) for d in out_dims))


def rows_call(x: DTensor, kernel: Callable):
    """``kernel(x)`` on x's batch (leading) shards, x whole elsewhere; the
    output placed as x's kept shards."""
    xt = _keep(x.placements, tuple(range(x.dim() - 1)))
    return local_call(kernel, (x,), (xt,), (xt,))[0]


def _layouts(a_placements, b_placements, rule) -> tuple:
    """(a's, b's, the output's) placements, ``rule(pa, pb)`` mesh dim by
    mesh dim."""
    return tuple(tuple(t) for t in zip(*(rule(pa, pb)
                                         for pa, pb in zip(a_placements, b_placements))))


def _shard_of(p, dim) -> bool:
    return isinstance(p, Shard) and p.dim == dim


def dense(x: DTensor, w: DTensor) -> DTensor:
    """``x @ w`` (x (..., in), w (in, out)) on shards, mesh dim by mesh dim
    as GSPMD lays out a sharded weight: where x is split over a leading
    (batch or token) dim, w is gathered whole there (FSDP's gather) and
    the output keeps x's split; else a column split of w (out) keeps x
    whole and splits the output's last dim; a row split of w (in) splits
    x's last dim alike and leaves a partial sum; else both are whole.
    DTensor's own choice can move the token split onto the model axis,
    which it then cannot multiply (batch 2 a data shard under a 16-wide
    model axis)."""
    last = x.dim() - 1

    def rule(px, pw):
        if isinstance(px, Shard) and px.dim < last:
            return px, Replicate(), px
        if _shard_of(pw, 1):
            return Replicate(), pw, Shard(last)
        if _shard_of(pw, 0):
            return Shard(last), pw, Partial()
        return Replicate(), Replicate(), Replicate()

    xt, wt, ot = _layouts(x.placements, w.placements, rule)
    return local_call(torch.matmul, (x, w), (xt, wt), (ot,))[0]


def embedding(tokens, table: DTensor) -> DTensor:
    """``F.embedding(tokens, table)`` on shards: where the tokens are split
    over a batch dim the table is gathered whole there; a vocabulary split
    of the table (dim 0) looks up the rows its shard holds (0 elsewhere),
    a partial sum summed once here; an embed split (dim 1) splits the
    output's last dim. Written out because DTensor's own lookup leaves a
    masked partial sum that its backward cannot turn back into a plain one
    (torch 2.11)."""
    tokens = _as_dtensor(tokens, table.device_mesh)
    last = tokens.dim()

    def rule(pt, pw):
        if isinstance(pt, Shard):
            return pt, Replicate(), pt
        if _shard_of(pw, 0):
            return Replicate(), pw, Partial()
        if _shard_of(pw, 1):
            return Replicate(), pw, Shard(last)
        return Replicate(), Replicate(), Replicate()

    tt, wt, ot = _layouts(tokens.placements, table.placements, rule)
    shape, offset = local_slice(table.shape, table.device_mesh, wt)
    v0, vl = offset[0], shape[0]

    def fn(tl, wl):
        idx = tl - v0
        inside = (idx >= 0) & (idx < vl)
        rows = torch.nn.functional.embedding(idx.clamp(0, vl - 1), wl)
        return rows * inside[..., None].to(rows.dtype)

    return _settle(local_call(fn, (tokens, table), (tt, wt), (ot,))[0])


def pick_last(logits: DTensor, index) -> DTensor:
    """``logits.gather(-1, index[..., None])[..., 0]`` on shards of the
    leading dims and of the last (vocabulary) dim: each rank picks the
    entries its vocabulary shard holds (0 elsewhere), and the result is a
    partial sum over the vocabulary-sharding mesh dims."""
    last = logits.dim() - 1
    lt = _keep(logits.placements, tuple(range(logits.dim())))
    it = _keep(lt, tuple(range(last)))
    out = tuple(Partial() if isinstance(p, Shard) and p.dim == last else p for p in lt)
    shape, offset = local_slice(logits.shape, logits.device_mesh, lt)
    v0, vl = offset[last], shape[last]

    def fn(ll, il):
        il = il - v0
        inside = (il >= 0) & (il < vl)
        got = ll.gather(-1, il.clamp(0, vl - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros_like(got))

    return local_call(fn, (logits, index), (lt, it), (out,))[0]


def along_dim1(x: DTensor, fn: Callable) -> DTensor:
    """``fn(x)`` for an ``fn`` that works along dim 1 only (a ring built
    from a prefill's sequence), on x's shards of every other dim, x whole
    along dim 1."""
    xt = _keep(x.placements, tuple(d for d in range(x.dim()) if d != 1))
    return local_call(fn, (x,), (xt,), (xt,))[0]


def ring_write(buf: DTensor, val, slot: int) -> DTensor:
    """``buf[:, slot] = val`` in place on a DTensor ring buf (B, C, ...), val
    (B, ...): each rank writes the slot into its local shard if it holds
    it (a ring split over its slots holds each slot once)."""
    mesh = buf.device_mesh
    bt = tuple(buf.placements)
    vt = tuple(Replicate() if not isinstance(p, Shard) or p.dim == 1 else
               Shard(p.dim if p.dim == 0 else p.dim - 1) for p in bt)
    val = _as_dtensor(val, mesh)
    if tuple(val.placements) != vt:
        val = val.redistribute(mesh, vt)
    shape, offset = local_slice(buf.shape, mesh, bt)
    local = buf.to_local()
    if offset[1] <= slot < offset[1] + shape[1]:
        local[:, slot - offset[1]] = val.to_local()
    return buf
