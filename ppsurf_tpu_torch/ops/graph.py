"""Construction of the FKAConv spatial graph on the device.

Port of `ppsurf_tpu/ops/graph.py` (replacing the reference's CPU
`get_fkaconv_ids`/`get_proj_ids`, `source/poco_data_loader.py:137-240`):
four voxel subsamplings and every kNN id set of the U-Net, through the
port's kNN (kernel K1 on CUDA tensors). `build_fkaconv_graph` builds one
cloud's, with a batch axis of 1 for the network; `build_fkaconv_graph_batch`
builds B clouds' with their own draws each, as the JAX package's
`voxel_subsample` splits its key over the batch (`subsample.py:106-115`).
A cloud's graph is 13 K1 calls: 9 at k=16 and 4 at k=1.
"""
from __future__ import annotations

import typing

import torch

from ppsurf_tpu_torch.ops.knn import knn, knn_blocks
from ppsurf_tpu_torch.ops.subsample import draw_subsample, voxel_subsample

KNN_K = 16  # FKAConv kernel neighborhood (`nn.py:465` kernel_size=16)
Draws = typing.List[typing.Tuple[torch.Tensor, torch.Tensor]]


def level_sizes(n: int, num_levels: int = 4, ratio: float = 0.25) -> typing.List[int]:
    """Support-point counts per level: max(1, int(n*0.25)) per level
    (`poco_data_loader.py:74-77`), aligned up to a multiple of 8 (capped at
    the parent size) for parity with the JAX package."""
    sizes = []
    cur = n
    for _ in range(num_levels):
        nxt = max(1, int(cur * ratio))
        nxt = min(cur, ((nxt + 7) // 8) * 8) if cur >= 8 else max(1, nxt)
        sizes.append(nxt)
        cur = nxt
    return sizes


def draw_graph(n: int, generator: torch.Generator, device: torch.device) -> Draws:
    """Per-level subsampling draws for a cloud of n points."""
    sizes = [n] + level_sizes(n)
    return [draw_subsample(sizes[lvl], generator, device) for lvl in range(4)]


def build_fkaconv_graph(pts: torch.Tensor, draws: Draws) -> typing.Dict[str, torch.Tensor]:
    """pts (N, 3) -> supports 'support1..4' (1, Nl, 3), down-path ids
    'ids00'..'ids44' (k=16) and up-path ids 'ids43'..'ids10' (k=1), each
    (1, M, k), key for key as reference `get_fkaconv_ids`."""
    sizes = level_sizes(pts.shape[0])
    supports = [pts]
    for lvl in range(4):
        tie, rot_u = draws[lvl]
        idx = voxel_subsample(supports[-1], sizes[lvl], tie, rot_u)
        supports.append(supports[-1][idx])

    # K1's blocking of each support level, made once for its kNN calls
    blocks = {id(p): knn_blocks(p) for p in supports} if pts.is_cuda else {}

    def nn_ids(points, queries, k):
        return knn(points, queries, min(k, points.shape[0]),
                   blocks=blocks.get(id(points)))[None]

    s0, s1, s2, s3, s4 = supports
    graph = {f"support{i}": supports[i][None] for i in range(1, 5)}
    pairs = {"00": (s0, s0), "01": (s0, s1), "11": (s1, s1), "12": (s1, s2),
             "22": (s2, s2), "23": (s2, s3), "33": (s3, s3), "34": (s3, s4),
             "44": (s4, s4)}
    for name, (points, queries) in pairs.items():
        graph[f"ids{name}"] = nn_ids(points, queries, KNN_K)
    for name, (points, queries) in {"43": (s4, s3), "32": (s3, s2),
                                    "21": (s2, s1), "10": (s1, s0)}.items():
        graph[f"ids{name}"] = nn_ids(points, queries, 1)
    return graph


def build_fkaconv_graph_batch(pts: torch.Tensor, draws: typing.Sequence[Draws]
                              ) -> typing.Dict[str, torch.Tensor]:
    """pts (B, N, 3) and one cloud's draws per item -> `build_fkaconv_graph`'s
    keys, each (B, ...)."""
    graphs = [build_fkaconv_graph(pts[b], draws[b]) for b in range(pts.shape[0])]
    return {key: torch.cat([g[key] for g in graphs]) for key in graphs[0]}


def build_proj_ids(pts: torch.Tensor, pts_query: torch.Tensor, k: int = 64) -> torch.Tensor:
    """k-NN of queries into the cloud for the decoder (reference
    `get_proj_ids`, `poco_data_loader.py:212-240`): (N, 3), (Q, 3) -> (Q, k)."""
    return knn(pts, pts_query, min(k, pts.shape[0]))


def build_proj_ids_batch(pts: torch.Tensor, pts_query: torch.Tensor, k: int = 64
                         ) -> torch.Tensor:
    """`build_proj_ids` of each item: (B, N, 3), (B, Q, 3) -> (B, Q, k)."""
    return torch.stack([build_proj_ids(pts[b], pts_query[b], k) for b in range(pts.shape[0])])
