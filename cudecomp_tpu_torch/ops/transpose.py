"""Global transpose engine (``cudecompTranspose_``,
``include/internal/transpose.h:196-905``).

One routine parameterized on (axis, direction) implements all four ops on
this rank's local pencil tensor, in three phases

    local pack  ->  exchange over one mesh dim  ->  local unpack

  * Slab degeneration: when the exchange dim has one rank, nothing is
    exchanged, and the two layout permutes (input order -> global order ->
    output order) compose into ONE net permute.  A cyclic net permute goes
    to the K1 kernel (``ops.cuda_kernels``); any other is
    ``permute().contiguous()``.
  * Evenly divisible extents: pack and unpack are reshapes around one
    ``all_to_all_single``.
  * Uneven extents use the padded-pencil format (see ``geometry``): each
    peer's chunk is padded with zeros to the maximum split, exchanged at
    uniform size, and the valid parts reassembled.
  * ``ring_pipelined`` (``transpose.h:683-744``) has no pack phase: step
    ``s`` sends peer ``me+s`` its chunk of the scatter dim straight from
    the input and unpacks the chunk received from peer ``me-s`` with one
    permute (K1 where it is cyclic) into the output.  On uneven extents
    the chunks are the pad-to-max size: a ragged last chunk is padded
    with zeros, a received chunk is cut to its sender's valid gather
    extent, and the scatter rows past this rank's own extent are zeroed.
  * Plans are cached per configuration and grid (and so per process
    group), the analog of the reference's graph cache (graph.h:37-51).

Input/output halo extents and padding are supported per op as in the
reference API (``include/cudecomp.h:545-660``); trailing component dims
(beyond the 3 pencil dims) travel with each element.  The outputs are new
tensors, except that a transpose which moves no data may return its input.
While the performance report is on, each call records one sample
(``performance.maybe_record``).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import torch
import torch.distributed as dist

from cudecomp_tpu_torch import geometry, performance
from cudecomp_tpu_torch.config import TransposeMethod
from cudecomp_tpu_torch.geometry import _check_extents
from cudecomp_tpu_torch.ops import cuda_kernels
from cudecomp_tpu_torch.parallel.collectives import (EXCHANGES, exchange_for,
                                                     ppermute_group)
from cudecomp_tpu_torch.utils.tracing import trace_range

_NAMES = ("x", "y", "z")


def _strip_halos_padding(local, order, halo, ms):
    """View of the interior (max-split extents) of a haloed/padded buffer."""
    sl = tuple(slice(halo[order[i]], halo[order[i]] + ms[order[i]])
               for i in range(3))
    return local[sl + (...,)]


def _add_halos_padding(local, order, halo, pad):
    """Surround the interior with zeroed halo regions and trailing padding."""
    lo = [halo[order[i]] for i in range(3)]
    extra = [halo[order[i]] + pad[order[i]] for i in range(3)]
    if not any(lo) and not any(extra):
        return local
    shape = tuple(local.shape[i] + lo[i] + extra[i] for i in range(3))
    out = local.new_zeros(shape + tuple(local.shape[3:]))
    out[tuple(slice(lo[i], lo[i] + local.shape[i]) for i in range(3))] = local
    return out


def _net_perm(cfg, ax: int, dir_: int):
    """NET local permutation of a communication-free transpose: input
    memory order -> output memory order, composed into one permute."""
    in_inv = cfg.inv_mem_order(ax)
    out_order = cfg.mem_order(ax + dir_)
    return tuple(in_inv[o] for o in out_order)


def _local_permute(t: torch.Tensor, perm) -> torch.Tensor:
    """Permute the 3 pencil dims of ``t`` (trailing dims follow): K1 for a
    cyclic perm, ``permute().contiguous()`` otherwise.  K1 takes contiguous
    input, so a strided view (an interior with its halos stripped) is
    copied first."""
    perm = tuple(perm)
    if perm in cuda_kernels.CYCLIC_PERMS:
        return cuda_kernels.cyclic_permute(t.contiguous(), perm)
    return t.permute(perm + tuple(range(3, t.dim()))).contiguous()


def _concat_gather_even(recv, P, Bs, Bg, gpos):
    """Evenly divisible unpack: (P*Bs, ..., Bg, ...) -> (Bs, ..., P*Bg, ...)."""
    shape = tuple(recv.shape)
    r = recv.reshape((P, Bs) + shape[1:])  # gather dim now at gpos + 1
    r = torch.movedim(r, 0, gpos)          # (Bs, ..., P, Bg, ...)
    new_shape = list(r.shape)
    new_shape[gpos:gpos + 2] = [P * Bg]
    return r.reshape(new_shape)


@lru_cache(maxsize=512)
def _build_transpose_fn(grid, ax: int, dir_: int, in_halo, out_halo,
                        in_pad, out_pad, method_key: str, n_comp_dims: int):
    """Build (and cache) the local function of one transpose configuration."""
    cfg = grid.config
    ax_out = ax + dir_

    comm_pd = geometry.shard_pdim_of_dim(ax_out, ax)
    comm_name = grid.comm_axis_name(ax, dir_)
    P = cfg.pdims[comm_pd]

    in_order = cfg.mem_order(ax)
    out_order = cfg.mem_order(ax_out)
    in_inv = cfg.inv_mem_order(ax)
    ms_in = geometry.max_splits(cfg, ax)

    # scatter dim: full in input, sharded in output; gather dim: vice versa
    scatter_dim, gather_dim = ax, ax_out
    splits_scatter = geometry._dist_splits(cfg, scatter_dim, P)
    splits_gather = geometry._dist_splits(cfg, gather_dim, P)
    if min(splits_scatter) == 0 or min(splits_gather) == 0:
        # reference rejects empty pencils (transpose.h:257-259)
        raise ValueError(
            f"transpose axis {ax}->{ax_out}: empty pencil (splits "
            f"{splits_scatter} / {splits_gather}); reduce pdims")
    off_scatter = geometry.get_split_offsets(
        cfg.effective_gdims_dist[scatter_dim], P)
    Bs = max(splits_scatter)
    Bg = max(splits_gather)
    even = (splits_scatter == (Bs,) * P) and (splits_gather == (Bg,) * P)
    comp_axes = tuple(range(3, 3 + n_comp_dims))
    # position of the gather dim after movedim(scatter -> 0)
    gpos = gather_dim + 1 if gather_dim < scatter_dim else gather_dim

    pipelined = method_key == "ring_pipelined"
    if P > 1 and not pipelined:
        exchange = exchange_for(method_key, grid, comm_name)

    # ring_pipelined: the chunk of peer p is rows off_scatter[p] + [0, Bs)
    # of the scatter dim; the unpack permute composes input order -> output
    # order in one permute (output dim j holds global axis out_order[j])
    pos_sc_in = in_order.index(scatter_dim)
    pos_sc_out = out_order.index(scatter_dim)
    pos_g_out = out_order.index(gather_dim)
    off_gather = geometry.get_split_offsets(
        cfg.effective_gdims_dist[gather_dim], P)
    perm_unpack = tuple(in_inv[out_order[j]] for j in range(3))
    ms_out = geometry.max_splits(cfg, ax_out)

    def pipelined_fn(t):
        group = grid.group(comm_name)
        me = dist.get_rank(group)
        interior = tuple(ms_out[out_order[i]] for i in range(3))
        out = t.new_empty(interior + tuple(t.shape[3:]))

        def chunk_for(peer):
            lo = off_scatter[peer]
            rows = min(Bs, t.shape[pos_sc_in] - lo)
            c = t.narrow(pos_sc_in, lo, rows)
            if rows < Bs:  # the ragged last chunk, padded to the max split
                pad = list(c.shape)
                pad[pos_sc_in] = Bs - rows
                c = torch.cat([c, c.new_zeros(pad)], dim=pos_sc_in)
            return c

        def unpack(blk, sender):
            width = splits_gather[sender]
            c = _local_permute(blk, perm_unpack)
            out.narrow(pos_g_out, off_gather[sender], width).copy_(
                c.narrow(pos_g_out, 0, width))

        unpack(chunk_for(me), me)
        for s in range(1, P):
            recv = ppermute_group(chunk_for((me + s) % P), group,
                                  [(j, (j + s) % P) for j in range(P)])
            unpack(recv, (me - s) % P)
        mine = splits_scatter[me]
        if mine < Bs:  # rows past this rank's extent: a neighbour's data
            out.narrow(pos_sc_out, mine, Bs - mine).zero_()
        return out

    def local_fn(local):
        t = _strip_halos_padding(local, in_order, in_halo, ms_in)

        if pipelined and P > 1:
            return _add_halos_padding(pipelined_fn(t), out_order, out_halo,
                                      out_pad)

        if P == 1:
            # slab degeneration: no exchange; one net permute
            net = _net_perm(cfg, ax, dir_)
            if net != (0, 1, 2):
                t = _local_permute(t, net)
            return _add_halos_padding(t, out_order, out_halo,
                                      out_pad).contiguous()

        # ---- pack: chunk the scatter dim into per-peer blocks ----
        with trace_range("cudecomp_tpu_torch.transpose_pack"):
            # to global-axis order (dims = X, Y, Z extents of this pencil)
            t = t.permute(in_inv + comp_axes)
            tm = torch.movedim(t, scatter_dim, 0)
            if even:
                blocks = tm.contiguous()
            else:
                blocks = tm.new_zeros((P * Bs,) + tuple(tm.shape[1:]))
                for p in range(P):
                    blocks[p * Bs:p * Bs + splits_scatter[p]] = tm[
                        off_scatter[p]:off_scatter[p] + splits_scatter[p]]
        # ---- exchange over the mesh dim ----
        recv = exchange(blocks, grid.group(comm_name), P, Bs)
        # ---- unpack: reassemble the gather dim ----
        with trace_range("cudecomp_tpu_torch.transpose_unpack"):
            if even:
                out_m = _concat_gather_even(recv, P, Bs, Bg, gpos)
            else:
                out_m = torch.cat(
                    [recv[q * Bs:(q + 1) * Bs].narrow(gpos, 0,
                                                      splits_gather[q])
                     for q in range(P)], dim=gpos)
            out_t = torch.movedim(out_m, 0, scatter_dim)
            out_t = out_t.permute(out_order + comp_axes).contiguous()
            return _add_halos_padding(out_t, out_order, out_halo, out_pad)

    return local_fn


def _transpose_impl(grid, arr, ax: int, dir_: int,
                    input_halo_extents, output_halo_extents,
                    input_padding, output_padding,
                    method: Optional[TransposeMethod]):
    cfg = grid.config
    ax_out = ax + dir_
    in_halo = _check_extents(input_halo_extents, "input_halo_extents")
    out_halo = _check_extents(output_halo_extents, "output_halo_extents")
    in_pad = _check_extents(input_padding, "input_padding")
    out_pad = _check_extents(output_padding, "output_padding")
    if method is None:
        method = cfg.transpose_method
    method_key = (method.value if isinstance(method, TransposeMethod)
                  else str(method))
    if method_key not in EXCHANGES and method_key != "ring_pipelined":
        raise ValueError(
            f"unknown transpose method {method_key!r}; available: "
            f"{sorted(EXCHANGES) + ['ring_pipelined']}")

    expected_in = geometry.pencil_buffer_shape(cfg, ax, in_halo, in_pad)
    if arr.dim() < 3 or tuple(arr.shape[:3]) != expected_in:
        raise ValueError(
            f"transpose {ax}->{ax_out}: input shape {tuple(arr.shape)} does "
            f"not match pencil-{_NAMES[ax]} layout {expected_in} "
            f"(halos {in_halo}, padding {in_pad}; trailing component dims "
            f"are allowed)")
    if arr.device != grid.device:
        raise ValueError(f"input on {arr.device}, grid on {grid.device}")

    fn = _build_transpose_fn(grid, ax, dir_, in_halo, out_halo, in_pad,
                             out_pad, method_key, arr.dim() - 3)
    op_name = f"transpose_{_NAMES[ax]}_to_{_NAMES[ax_out]}"

    def perf_key():
        # the key and bytes of the JAX package's samples: everything but
        # the self block of this rank's interior leaves the rank
        P = cfg.pdims[geometry.shard_pdim_of_dim(ax_out, ax)]
        ms_in = geometry.max_splits(cfg, ax)
        nbytes = int(ms_in[0] * ms_in[1] * ms_in[2] * arr.element_size()
                     * (P - 1) / P)
        key = (op_name, cfg.gdims, cfg.pdims, method_key,
               performance.dtype_name(arr.dtype), in_halo, out_halo, in_pad,
               out_pad)
        return key, nbytes

    with trace_range(f"cudecomp_tpu_torch.{op_name}"):
        return performance.maybe_record(perf_key, fn, arr)


def _public(ax, dir_):
    src, dst = _NAMES[ax], _NAMES[ax + dir_]

    def op(grid, arr, input_halo_extents=None, output_halo_extents=None,
           input_padding=None, output_padding=None, method=None):
        return _transpose_impl(grid, arr, ax, dir_,
                               input_halo_extents, output_halo_extents,
                               input_padding, output_padding, method)

    op.__name__ = f"transpose_{src}_to_{dst}"
    op.__doc__ = (
        f"Global transpose {src.upper()}-pencil -> {dst.upper()}-pencil of "
        f"this rank's local tensor (cudecompTranspose{src.upper()}To"
        f"{dst.upper()}, include/cudecomp.h); accepts per-op input/output "
        f"halo extents and padding.")
    return op


transpose_x_to_y = _public(0, +1)
transpose_y_to_z = _public(1, +1)
transpose_y_to_x = _public(1, -1)
transpose_z_to_y = _public(2, -1)
