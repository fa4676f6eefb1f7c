"""Latent accumulation and implicit-field evaluation for reconstruction.

Port of `ppsurf_tpu/recon/field.py` (reference `source/poco_model.py:183-237`
and `source/poco_utils.py:67-82`):

- `LatentEncoder`: `gen_subsample_manifold_iter` passes over a random
  partition of the cloud (a permutation of the size bucketed up to 5000,
  taken modulo n), encoding each 10k-point chunk with its own FKAConv
  graph and averaging every point's latents by scatter-add. Every point is
  encoded at least once per pass by construction.
- `FieldEvaluator`: softmax(p0) - softmax(p1) at query points, in chunks
  of 50 048. Per chunk: the k=64 kNN (K1), the decoder tail on the
  fc1-folded latents (K3), fc8; for PPSurf also the P-point patch,
  PointNet (K4, STN head, K5) and the MLP; then the softmax difference.
  POCO's field is the softmax of fc8's two logits. The patch is the prefix
  of the k nearest-first ids where P <= k; where P > k (the 100NN and
  200NN configurations) one K1 call at k=P finds the patch and its first k
  ids are the decoder's (K1 orders nearest first, ties to the lower id, so
  they are the k=64 call's). A cloud of N < 64 points takes k = N and
  P = min(P, N), as the JAX package does (`field.py:113-132, 528-530`).
- `FieldEvaluator.refine_bisection`: all bisection rounds of a vertex
  chunk back to back on the device. By default on the candidate path
  (`_make_refine_cand_chunk`, `field.py:292-369`): one kc=192 kNN at the
  edge midpoints (K1) per chunk, then per round each iterate's exact 64
  nearest picked from those candidates (K2) in place of a full kNN; the
  vertices whose certificate fails are refined again on the plain path,
  where every round is a full field evaluation with its own kNN.
- Sharded evaluation (`FieldEvaluator(devices=[...])`, the JAX package's
  `_make_eval_sharded`, `field.py:187-224, 745-764`): the cloud, the
  projected latents, the weights and the kernels' tables are replicated
  on each listed device, and a grid evaluation sends one full chunk to
  each device in turn from the calling thread (`parallel/mesh.py` says
  why one thread), then gathers the values in query order on the first
  device. Full chunks left over (fewer than the devices) and the tail run
  on the first device, and so does refinement, as in the JAX package.
  Every chunk runs the same code on the same inputs, so the field equals
  the single-device one.

Every entry point runs under `torch.inference_mode()`: no autograd graph
is recorded, whether or not the network's parameters require gradients.

The cloud is Morton-sorted once per shape and every query batch per call,
so neighbouring queries share K1's blocks; results are scattered back to
the caller's order.
"""
from __future__ import annotations

import copy
import dataclasses
import typing

import numpy as np
import torch

from ppsurf_tpu_torch.ops.decoder_tail import decoder_tables, decoder_tail
from ppsurf_tpu_torch.ops.graph import Draws, build_fkaconv_graph, draw_graph
from ppsurf_tpu_torch.ops.knn import dist2_rows, knn, knn_blocks
from ppsurf_tpu_torch.ops.morton import morton_order
from ppsurf_tpu_torch.ops.patches import patch_space
from ppsurf_tpu_torch.ops.pointnet_att import pad_rows, pointnet_att, pointnet_tables
from ppsurf_tpu_torch.ops.topk_rows import topk_rows
from ppsurf_tpu_torch.train.model import ModelSpec
from ppsurf_tpu_torch.utils.spans import span

Transform = typing.Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# candidates per vertex of the candidate refinement (`field.py:283-289`):
# the kc nearest cloud points of the edge midpoint certify the exact k-NN
# of every iterate on the edge when tau_k(m) + r < tau_kc(m) - r
REFINE_CAND_K = 192


def _ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def _moved(x, device: torch.device):
    """`x` (a tensor, or a dataclass, tuple, list or dict holding
    tensors) with every tensor copied to `device`."""
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: _moved(getattr(x, f.name), device)
                                         for f in dataclasses.fields(x)})
    if isinstance(x, (tuple, list)):
        return type(x)(_moved(v, device) for v in x)
    if isinstance(x, dict):
        return {k: _moved(v, device) for k, v in x.items()}
    return x


@dataclasses.dataclass
class _Replica:
    """What one device evaluates the field with: the network, the sorted
    cloud with K1's blocking, the projected latents and the kernels'
    tables, all on `device`."""

    device: torch.device
    net: torch.nn.Module
    pts: torch.Tensor
    blocks: typing.Any
    latents: torch.Tensor
    decoder: typing.Any
    point_net: typing.Any


@dataclasses.dataclass
class EncoderDraws:
    """Random inputs of one encoding: `perms` (iters, nb) permutations of
    the bucketed size, and one graph's subsampling draws per chunk."""

    perms: torch.Tensor
    graphs: typing.List[Draws]


class LatentEncoder:
    """Accumulate per-point latents over random-partition passes."""

    BUCKET = 5000  # cloud sizes round up to this (`field.py:388-399`)

    def __init__(self, net, spec: ModelSpec):
        self.net = net
        self.spec = spec

    def layout(self, n: int) -> typing.Tuple[int, int, int]:
        """(bucketed size nb, chunk size s, chunks per pass)."""
        s = min(self.spec.gen_subsample_manifold, n)
        nb = -(-n // self.BUCKET) * self.BUCKET if n > s else n
        return nb, s, -(-nb // s)

    def draw(self, n: int, generator: torch.Generator,
             device: torch.device) -> EncoderDraws:
        nb, s, num_chunks = self.layout(n)
        iters = self.spec.gen_subsample_manifold_iter
        perms = torch.stack([
            torch.randperm(nb, generator=generator, device=device)
            for _ in range(iters)
        ])
        graphs = [draw_graph(s, generator, device) for _ in range(iters * num_chunks)]
        return EncoderDraws(perms, graphs)

    @torch.inference_mode()
    def __call__(self, pts: torch.Tensor,
                 generator: typing.Optional[torch.Generator] = None,
                 draws: typing.Optional[EncoderDraws] = None) -> torch.Tensor:
        """pts (N, 3) on the device -> (N, L) f32 averaged latents."""
        with span("encode"):
            n = pts.shape[0]
            nb, s, num_chunks = self.layout(n)
            if draws is None:
                if generator is None:
                    raise ValueError("LatentEncoder needs a generator or draws")
                draws = self.draw(n, generator, pts.device)
            padded = num_chunks * s
            perms = draws.perms.to(pts.device) % n
            ids = torch.cat([perms, perms[:, : padded - nb]], dim=1).reshape(-1, s)
            latent_dim = self.spec.network_latent_size
            latent_sum = torch.zeros((n, latent_dim), dtype=torch.float32, device=pts.device)
            counts = torch.zeros((n,), dtype=torch.float32, device=pts.device)
            ones = torch.ones((s,), dtype=torch.float32, device=pts.device)
            for p in range(perms.shape[0]):
                with span("encode.pass"):
                    for c in range(p * num_chunks, (p + 1) * num_chunks):
                        chunk_ids = ids[c]
                        with span("encode.graph"):
                            chunk_pts = pts[chunk_ids]
                            data = {"pts": chunk_pts[None]}
                            data.update(build_fkaconv_graph(chunk_pts, draws.graphs[c]))
                        with span("encode.net"):
                            lat = self.net.get_latent(data)[0]
                        with span("encode.accumulate"):
                            latent_sum.index_add_(0, chunk_ids, lat.float())
                            counts.index_add_(0, chunk_ids, ones)
            return latent_sum / torch.clamp(counts, min=1.0)[:, None]


class FieldEvaluator:
    """Chunked evaluation of the occupancy field on the latents' device."""

    @torch.inference_mode()
    def __init__(self, net, spec: ModelSpec, pts: np.ndarray,
                 latents: torch.Tensor, transform: typing.Optional[Transform] = None,
                 devices: typing.Optional[typing.Sequence[typing.Union[str, torch.device]]] = None):
        """pts (N, 3) the cloud that carries the latents and the patches;
        latents (N, L) on the evaluation device; transform optional
        (values (C,), queries (C, 3)) -> (C,) post-processing of the field
        (e.g. an analytic blend), seen by growth and refinement alike,
        applied on the evaluation device. `devices`, where given, shard the
        grid evaluation: one replica a listed device (a device may be
        listed twice), the first the evaluation device, which the latents
        move to."""
        self.net = net
        self.spec = spec
        self.transform = transform
        if devices:
            latents = latents.to(devices[0])
        self.device = latents.device
        self.dtype = spec.dtype
        self.chunk = _ceil_to(spec.rec_batch_size, 128)
        self.k = min(spec.k, pts.shape[0])
        # PPSurf's patch size (0 for POCO): the prefix of the decoder's
        # ids where it fits in them, else its own wider kNN
        self.patch_k = min(spec.num_pts_local, pts.shape[0]) if spec.is_ppsurf else 0
        self.stat_queries = 0
        self.stat_cert_failed = 0  # vertices the candidate path handed back
        # on the card the PyTorch products of a chunk (fc8, the STN head,
        # the MLP) run on `chunk` rows, the tail chunk padded: cuBLAS picks
        # its algorithm by the row count, so a query's value would
        # otherwise depend on the size of the call that holds it
        self.fixed_rows = self.chunk if self.device.type == "cuda" else None

        self._bbox = (pts.min(axis=0), pts.max(axis=0))
        order = morton_order(pts, *self._bbox)
        self.pts = torch.from_numpy(np.ascontiguousarray(pts[order], np.float32)).to(self.device)
        # K1's blocking of the cloud, made once for every chunk's kNN
        self.blocks = knn_blocks(self.pts) if self.pts.is_cuda else None
        # fold fc1's latent rows + bias into the per-point latents once per
        # shape (`field.py:469-479, 540-563`): fc1 keeps the rel term only
        fc1 = net.projection.fc1
        lat_dim = latents.shape[1]
        order_t = torch.from_numpy(order).to(self.device)
        lat = latents.float()[order_t]
        self.latents = (
            torch.matmul(lat, fc1.kernel.float()[:lat_dim]) + fc1.bias.float()
        ).to(self.dtype).contiguous()
        self.decoder = decoder_tables(net.projection, self.dtype)
        self.point_net = pointnet_tables(net.point_net) if spec.is_ppsurf else None
        first = _Replica(self.device, net, self.pts, self.blocks, self.latents, self.decoder,
                         self.point_net)
        self.replicas = [first] + [self._replica(first, torch.device(d))
                                   for d in (devices or [])[1:]]

    @staticmethod
    def _replica(first: _Replica, device: torch.device) -> _Replica:
        """A copy of the first replica on `device`: the tensors copied, so
        every replica computes on the same bits."""
        return _Replica(device, copy.deepcopy(first.net).to(device),
                        *(_moved(x, device) for x in (first.pts, first.blocks, first.latents,
                                                     first.decoder, first.point_net)))

    def _field(self, rep: _Replica, q: torch.Tensor,
               ids: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (C, 3) on `rep`'s device -> the field (C,) there, before the
        transform."""
        patch_ids = None
        if self.patch_k > self.k:
            patch_ids = knn(rep.pts, q, self.patch_k, blocks=rep.blocks)
            if ids is None:
                ids = patch_ids[:, : self.k].contiguous()
        elif ids is None:
            ids = knn(rep.pts, q, self.k, blocks=rep.blocks)
        rows = self.fixed_rows
        pooled = pad_rows(decoder_tail(rep.latents, rep.pts, q, ids, rep.decoder), rows)
        data = {"feat_proj": rep.net.projection.fc8(pooled)[None]}
        if self.spec.is_ppsurf:
            if patch_ids is None:
                patch_ids = ids[:, : self.patch_k]
            patches = patch_space(rep.pts[patch_ids], q)
            feat_pn = pointnet_att(patches.to(self.dtype), rep.point_net, rows)
            data["feat_pn"] = pad_rows(feat_pn, rows)[None]
        logits = rep.net.from_latent(data)[0][:q.shape[0]]
        probs = torch.softmax(logits.float(), dim=-1)
        # p(class 0) - p(class 1): zero-crossing is the surface
        # (`poco_utils.py:79-81`)
        return probs[:, 0] - probs[:, 1]

    def _finish(self, vals: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
        return vals if self.transform is None else self.transform(vals, q)

    @torch.inference_mode()
    def eval_chunk(self, q: torch.Tensor,
                   ids: typing.Optional[torch.Tensor] = None) -> torch.Tensor:
        """q (C, 3) f32 on the device -> field values (C,) f32. `ids` (C, k)
        are q's k nearest cloud ids, nearest first, where the caller has
        them (the candidate refinement); else K1 finds them."""
        return self._finish(self._field(self.replicas[0], q, ids), q)

    def _sorted(self, *arrays: np.ndarray, order: np.ndarray) -> typing.List[torch.Tensor]:
        return [torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)[order]))
                .to(self.device) for a in arrays]

    @torch.inference_mode()
    def __call__(self, queries: np.ndarray) -> np.ndarray:
        """queries (M, 3) -> field (M,), in Morton-sorted chunks."""
        m = queries.shape[0]
        if m == 0:
            return np.zeros((0,), np.float32)
        self.stat_queries += m
        with span("field") as sp:
            with span("field.sort"):
                order = morton_order(queries, *self._bbox)
                (q,) = self._sorted(queries, order=order)
            chunks = [q[s:s + self.chunk] for s in range(0, m, self.chunk)]
            sp.add(queries=m)
            d = len(self.replicas)
            full = m // self.chunk
            vals, i = [], 0
            while d > 1 and full - i >= d:  # one full chunk a replica, in order
                group = []
                for j, rep in enumerate(self.replicas):
                    with span("field.chunk"):
                        group.append(self._field(rep, chunks[i + j].to(rep.device)))
                vals += [self._finish(v.to(self.device), chunks[i + j])
                         for j, v in enumerate(group)]
                i += d
            for c in chunks[i:]:
                with span("field.chunk"):
                    vals.append(self.eval_chunk(c))
            vals = torch.cat(vals)
            with span("readback") as rb:
                host = vals.cpu()
                rb.add(bytes=4 * m)
            out = np.empty((m,), np.float32)
            out[order] = host.numpy()
            return out

    @torch.inference_mode()
    def refine_bisection(self, v: np.ndarray, v1: np.ndarray, v2: np.ndarray,
                         p1: np.ndarray, p2: np.ndarray, iters: int,
                         force_full: bool = False) -> np.ndarray:
        """Bisection refinement (reference `poco_utils.py:111-168`) of
        vertices v between grid points v1/v2 with field values p1/p2; all
        `iters` rounds of a chunk run on the device (`_refine_impl`,
        `field.py:854-1005`). The candidate path is taken unless
        `force_full` or the cloud has no more than REFINE_CAND_K + k
        points; `force_full` runs the plain path (`_make_refine_chunk`,
        `field.py:227-263`) for every vertex."""
        m = v.shape[0]
        if m == 0 or iters == 0:
            return np.asarray(v, np.float32)
        self.stat_queries += m * iters
        with span("field.refine") as sp:
            sp.add(queries=m * iters)
            order = morton_order(v, *self._bbox)
            sorted_in = self._sorted(v, v1, v2, p1, p2, order=order)
            if force_full or self.pts.shape[0] <= REFINE_CAND_K + self.k:
                refined = self._refine_plain(*sorted_in, iters)
            else:
                refined = self._refine_cand(*sorted_in, iters)
            with span("readback") as rb:
                host = refined.cpu()
                rb.add(bytes=12 * m)
            res = np.empty((m, 3), np.float32)
            res[order] = host.numpy()
            return res

    def _bisect(self, v: torch.Tensor, v1: torch.Tensor, v2: torch.Tensor,
                p1: torch.Tensor, p2: torch.Tensor, iters: int,
                ids_at: typing.Optional[typing.Callable[[torch.Tensor], torch.Tensor]] = None,
                ) -> torch.Tensor:
        """`iters` bisection rounds of one chunk; `ids_at(v)` gives the
        iterate's k nearest ids where the caller knows a cheaper way."""
        for _ in range(iters):
            preds = self.eval_chunk(v, None if ids_at is None else ids_at(v))
            m1 = (preds * p1) > 0
            v1 = torch.where(m1[:, None], v, v1)
            p1 = torch.where(m1, preds, p1)
            m2 = (preds * p2) > 0
            v2 = torch.where(m2[:, None], v, v2)
            p2 = torch.where(m2, preds, p2)
            v = 0.5 * (v1 + v2)
        return v

    def _refine_plain(self, v, v1, v2, p1, p2, iters: int) -> torch.Tensor:
        """Plain path on Morton-sorted device tensors: each round's field
        evaluation finds its own kNN."""
        c = self.chunk
        return torch.cat([self._bisect(v[s:s + c], v1[s:s + c], v2[s:s + c],
                                       p1[s:s + c], p2[s:s + c], iters)
                          for s in range(0, v.shape[0], c)])

    def _refine_cand(self, v, v1, v2, p1, p2, iters: int) -> torch.Tensor:
        """Candidate path on Morton-sorted device tensors
        (`_make_refine_cand_chunk`, `field.py:292-369`).

        Every iterate x lies on its edge [v1, v2], so |x - mid| <= r (half
        the edge). A point outside the kc nearest of mid is then at least
        tau_kc(mid) - r from x and the k-th candidate at most
        tau_k(mid) + r, so where tau_k + r < tau_kc - r the candidates
        hold x's exact k nearest (the 1e-6 margin absorbs f32 rounding).
        Each round computes x's distances to its candidates in K1's
        arithmetic and picks the k nearest with K2, so the ids are K1's
        at x up to the order of exactly tied distances. Vertices whose
        certificate fails are refined again on the plain path."""
        kc, k, c = REFINE_CAND_K, self.k, self.chunk
        out, cert = [], []
        for s in range(0, v.shape[0], c):
            e1, e2 = v1[s:s + c], v2[s:s + c]
            mid = 0.5 * (e1 + e2)
            r = 0.5 * torch.sqrt(((e1 - e2) ** 2).sum(dim=-1))
            ids_c = knn(self.pts, mid, kc, blocks=self.blocks)  # (C, kc), nearest first
            cpts = self.pts[ids_c]  # (C, kc, 3)
            d2m = dist2_rows(mid, cpts)
            tau_k = torch.sqrt(d2m[:, k - 1])
            tau_c = torch.sqrt(d2m[:, kc - 1])
            cert.append((tau_k + r) < (tau_c - r) * (1.0 - 1e-6))

            def ids_at(x, ids_c=ids_c, cpts=cpts):
                return ids_c.gather(1, topk_rows(dist2_rows(x, cpts), k))

            out.append(self._bisect(v[s:s + c], e1, e2, p1[s:s + c], p2[s:s + c],
                                    iters, ids_at))
            del ids_c, cpts, d2m, ids_at  # 190 MB a chunk of 50 048
        refined = torch.cat(out)
        with span("readback") as rb:  # nonzero reads the count back
            bad = torch.nonzero(~torch.cat(cert)).flatten()
            rb.add(bytes=8)
        self.stat_cert_failed += int(bad.numel())
        if bad.numel():
            refined[bad] = self._refine_plain(v[bad], v1[bad], v2[bad], p1[bad],
                                              p2[bad], iters)
        return refined
