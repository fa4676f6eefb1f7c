"""Plain PyTorch reference of PPSurf and POCO reconstruction, in float32.

Written from the published networks as the JAX package states them
(`ppsurf_tpu/models/{fkaconv,decoder,pointnet,ppsurf,poco}.py`,
`ppsurf_tpu/ops/{graph,subsample}.py`, `ppsurf_tpu/recon/field.py`), and
importing none of it: the FKAConv U-Net encoder over random partitions of
the cloud, the interpolation-attention decoder, PPSurf's PointNet branch
and MLP, the field softmax(p0) - softmax(p1), and the vertex bisection.
PPSurf's patch is the P nearest cloud points at any P, its own search
where P is above the decoder's k.
Every module is plain tensor arithmetic on a flat weight dict with the
flax names of the committed `.npz` ('params/encoder/cv0/fc1/kernel', ...);
BatchNorm runs on its running statistics (eval mode), nothing folded.

Every product goes through `Plain.q`, identity in float32 (TF32 off): the
control swaps in a rounding to a lower precision (`fp8_e4m3`).

The encoder's random draws (the partitions and the subsampling's
uniforms) are worked out again here from the generator seed that the
benchmark hands to both sides, in the order the model's inference path
draws them (`LatentEncoder.draw`): every pass's permutation, then each
chunk's four levels of (tie (n,), rotation (4, 3)) uniforms.
"""
from __future__ import annotations

import math
import typing

import torch
import torch.nn.functional as F

Tensor = torch.Tensor
BUCKET = 5000  # cloud sizes round up to this before the partition
KNN_K = 16  # FKAConv neighbourhood
HALVINGS = 4  # voxel-size levels of the subsampling
BN_EPS = 1e-5


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def fp8_e4m3(x: Tensor) -> Tensor:
    """x rounded to float8 e4m3 with one scale a tensor (its largest
    magnitude at e4m3's 448), back in float32. Under autograd the rounding
    passes the gradient through unchanged (a cast's backward would round
    the gradient to float8 too, where a step's gradients underflow)."""
    with torch.no_grad():
        amax = x.abs().amax()
        if not torch.isfinite(amax) or amax == 0:
            return x
        s = amax / 448.0
        r = (x / s).to(torch.float8_e4m3fn).float() * s
    return x + (r - x).detach() if x.requires_grad else r


# --- kNN and subsampling -------------------------------------------------

def dist2(points: Tensor, queries: Tensor) -> Tensor:
    """(Q, N) squared distances, (px-qx)^2 + (py-qy)^2 + (pz-qz)^2 summed
    in that order with each step rounded."""
    d = points[None, :, 0] - queries[:, 0, None]
    acc = d * d
    d = points[None, :, 1] - queries[:, 1, None]
    acc = acc + d * d
    d = points[None, :, 2] - queries[:, 2, None]
    return acc + d * d


def knn(points: Tensor, queries: Tensor, k: int, block: int = 0) -> Tensor:
    """(Q, k) ids of each query's k nearest points, nearest first, ties to
    the lower id (a stable sort), in blocks of queries."""
    k = min(k, points.shape[0])
    block = block or max(1, (1 << 25) // max(1, points.shape[0]))
    out = []
    for s in range(0, queries.shape[0], block):
        d2 = dist2(points, queries[s:s + block])
        out.append(torch.sort(d2, dim=1, stable=True).indices[:, :k])
    return torch.cat(out)


def level_sizes(n: int, num_levels: int = 4, ratio: float = 0.25) -> typing.List[int]:
    sizes, cur = [], n
    for _ in range(num_levels):
        nxt = max(1, int(cur * ratio))
        nxt = min(cur, ((nxt + 7) // 8) * 8) if cur >= 8 else max(1, nxt)
        sizes.append(nxt)
        cur = nxt
    return sizes


def rotation(u: Tensor) -> Tensor:
    """Uniform rotation from three uniforms (Shoemake's quaternion)."""
    r1, r2, r3 = u[0], u[1], u[2]
    two_pi = 2.0 * math.pi
    x = torch.sqrt(1.0 - r1) * torch.sin(two_pi * r2)
    y = torch.sqrt(1.0 - r1) * torch.cos(two_pi * r2)
    z = torch.sqrt(r1) * torch.sin(two_pi * r3)
    w = torch.sqrt(r1) * torch.cos(two_pi * r3)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)]),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)]),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]),
    ])


def first_in_voxel(pts: Tensor, vox: Tensor, tie: Tensor) -> Tensor:
    """Per point: is it its voxel's representative, the one of least
    `tie` (the lower index on equal ties)?"""
    cell = torch.floor((pts - pts.amin(dim=0)[None]) / vox).to(torch.int64)
    dim = cell.max() + 2
    vox_id = (cell[:, 0] * dim + cell[:, 1]) * dim + cell[:, 2]
    by_tie = torch.argsort(tie, stable=True)
    order = by_tie[torch.argsort(vox_id[by_tie], stable=True)]
    vs = vox_id[order]
    first = torch.ones_like(vs, dtype=torch.bool)
    first[1:] = vs[1:] != vs[:-1]
    flags = torch.zeros_like(first)
    flags[order] = first
    return flags


def subsample(pts: Tensor, n_support: int, tie: Tensor, rot_u: Tensor) -> Tensor:
    """Indices of n_support points: representatives of the coarsest voxel
    level rank first, then each finer level's, then the uniform fill."""
    extent = torch.linalg.vector_norm(pts.amax(dim=0) - pts.amin(dim=0))
    vox0 = torch.clamp(extent / torch.sqrt(torch.tensor(float(n_support), device=pts.device)),
                       min=1e-12)
    score = tie.clone()
    for lvl in range(HALVINGS):
        flags = first_in_voxel(pts @ rotation(rot_u[lvl]).T, vox0 / (2.0 ** lvl), tie)
        score = score + torch.where(flags, 2.0 * 2.0 ** (HALVINGS - lvl), 0.0)
    return torch.topk(score, n_support).indices


def graph(pts: Tensor, draws) -> typing.Dict[str, Tensor]:
    """The U-Net's supports and neighbour ids for one chunk."""
    sizes = level_sizes(pts.shape[0])
    sup = [pts]
    for lvl in range(4):
        tie, rot_u = draws[lvl]
        sup.append(sup[-1][subsample(sup[-1], sizes[lvl], tie, rot_u)])
    g = {f"s{i}": sup[i] for i in range(5)}
    for a, b in ((0, 0), (0, 1), (1, 1), (1, 2), (2, 2), (2, 3), (3, 3), (3, 4), (4, 4)):
        g[f"ids{a}{b}"] = knn(sup[a], sup[b], KNN_K)
    for a, b in ((4, 3), (3, 2), (2, 1), (1, 0)):
        g[f"ids{a}{b}"] = knn(sup[a], sup[b], 1)
    return g


# --- the networks ----------------------------------------------------------

class Plain:
    """One network (config['kind'] 'ppsurf' or 'poco') on flat weights."""

    def __init__(self, weights: typing.Dict[str, Tensor], config: dict,
                 q: typing.Callable[[Tensor], Tensor] = lambda x: x):
        self.W = weights
        self.c = config
        self.q = q
        self.ppsurf = config["kind"] == "ppsurf"
        self.act = F.silu if self.ppsurf else torch.relu

    def p(self, path: str) -> Tensor:
        return self.W["params/" + path]

    def dense(self, x: Tensor, path: str) -> Tensor:
        y = self.q(x) @ self.q(self.p(path + "/kernel"))
        bias = self.W.get(f"params/{path}/bias")
        return y if bias is None else y + bias

    def affine(self, y: Tensor, path: str) -> Tensor:
        return y * self.p(path + "/scale") + self.p(path + "/bias")

    def bn(self, x: Tensor, path: str) -> Tensor:
        mean = self.W[f"batch_stats/{path}/mean"]
        var = self.W[f"batch_stats/{path}/var"]
        return self.affine((x - mean) / torch.sqrt(var + BN_EPS), path)

    def inorm(self, x: Tensor, path: str) -> Tensor:
        """Instance norm over every axis but the channel (one chunk)."""
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        return self.affine((x - mean) / torch.sqrt(var + BN_EPS), path)

    # FKAConv U-Net
    def fkaconv(self, x: Tensor, pts: Tensor, sup: Tensor, ids: Tensor, path: str) -> Tensor:
        local = pts[ids] - sup[:, None, :]  # (M, K, 3)
        dist = torch.sqrt(torch.clamp((local * local).sum(-1), min=0.0))
        local = local / self.W[f"batch_stats/{path}/norm_radius"]
        dw = torch.sigmoid(-self.p(path + "/alpha") * dist + self.p(path + "/beta"))
        dw_sum = dw.sum(dim=1, keepdim=True)
        dw_sum = dw_sum + (dw_sum == 0.0).float() + 1e-6
        dw = (dw / dw_sum * dist.shape[1])[..., None]
        k = ids.shape[-1]
        mat = self.dense(local, path + "/fc1")
        mat = self.act(mat if k == 1 else self.inorm(mat, path + "/bn1"))
        mat = torch.cat([mat, (mat * dw).amax(dim=1, keepdim=True).expand_as(mat)], -1)
        mat = self.dense(mat, path + "/fc2")
        mat = self.act(mat if k == 1 else self.inorm(mat, path + "/bn2"))
        mat = torch.cat([mat, (mat * dw).amax(dim=1, keepdim=True).expand_as(mat)], -1)
        mat = self.act(self.dense(mat, path + "/fc3")) * dw  # (M, K, ks)
        feats = torch.einsum("mkc,mkj->mcj", self.q(x[ids]), self.q(mat))
        cv = self.p(path + "/cv")
        return self.q(feats.reshape(feats.shape[0], -1)) @ self.q(cv.reshape(-1, cv.shape[-1]))

    def resblock(self, x, pts, sup, ids, path):
        h = torch.relu(self.bn(self.dense(x, path + "/cv0"), path + "/bn0"))
        h = self.fkaconv(h, pts, sup, ids, path + "/cv1")
        h = torch.relu(self.bn(h, path + "/bn1"))
        h = self.bn(self.dense(h, path + "/cv2"), path + "/bn2")
        short = x
        if f"params/{path}/shortcut/kernel" in self.W:
            short = self.bn(self.dense(x, path + "/shortcut"), path + "/bn_shortcut")
        if short.shape[0] != h.shape[0]:  # a downsampling level: max over the neighbours
            short = short[ids].amax(dim=1)
        return torch.relu(h + short)

    def encode_chunk(self, g: typing.Dict[str, Tensor]) -> Tensor:
        """(n, latent) latents of one chunk's points."""
        e = "encoder/"
        s0, s1, s2, s3, s4 = (g[f"s{i}"] for i in range(5))
        x = torch.ones_like(s0)
        x0 = torch.relu(self.bn(self.fkaconv(x, s0, s0, g["ids00"], e + "cv0"), e + "bn0"))
        x0 = self.resblock(x0, s0, s0, g["ids00"], e + "resnetb01")
        x1 = self.resblock(x0, s0, s1, g["ids01"], e + "resnetb10")
        x1 = self.resblock(x1, s1, s1, g["ids11"], e + "resnetb11")
        x2 = self.resblock(x1, s1, s2, g["ids12"], e + "resnetb20")
        x2 = self.resblock(x2, s2, s2, g["ids22"], e + "resnetb21")
        x3 = self.resblock(x2, s2, s3, g["ids23"], e + "resnetb30")
        x3 = self.resblock(x3, s3, s3, g["ids33"], e + "resnetb31")
        x4 = self.resblock(x3, s3, s4, g["ids34"], e + "resnetb40")
        x4 = self.resblock(x4, s4, s4, g["ids44"], e + "resnetb41")
        if self.ppsurf:  # the global-max bottleneck; POCO's published net discards it
            x5 = x4.amax(dim=0, keepdim=True).expand_as(x4)
            x4 = torch.relu(self.bn(self.dense(torch.cat([x4, x5], -1), e + "cv5"), e + "bn5"))
        up = x4
        for ids, skip, name in ((g["ids43"], x3, "3d"), (g["ids32"], x2, "2d"),
                                (g["ids21"], x1, "1d"), (g["ids10"], x0, "0d")):
            up = torch.cat([up[ids[:, 0]], skip], -1)
            up = torch.relu(self.bn(self.dense(up, e + "cv" + name), e + "bn" + name))
        return self.dense(up, e + "fcout")

    # the field
    def decoder(self, latents: Tensor, pts: Tensor, q: Tensor, ids: Tensor) -> Tensor:
        d = "projection/"
        rel = q[:, None, :] - pts[ids]
        x = torch.relu(self.dense(torch.cat([latents[ids], rel], -1), d + "fc1"))
        x = torch.relu(self.dense(x, d + "fc2"))
        x = torch.relu(self.dense(x, d + "fc3"))
        att = torch.softmax(self.dense(x, d + "fc_query"), dim=1).mean(dim=-1)  # (Q, k)
        out = (att[..., None] * self.dense(x, d + "fc_value")).sum(dim=1)
        return self.dense(out, d + "fc8")

    def pointnet(self, patches: Tensor) -> Tensor:
        p = "point_net/"

        def dbr(x, conv, bn):
            return torch.relu(self.bn(self.dense(x, p + conv), p + bn))

        x = dbr(patches, "conv0a", "bn0a")
        x = dbr(x, "conv0b", "bn0b")
        s = dbr(x, "stn2/conv1", "stn2/bn1")
        s = dbr(s, "stn2/conv2", "stn2/bn2")
        s = dbr(s, "stn2/conv3", "stn2/bn3").amax(dim=1)
        s = dbr(s, "stn2/fc1", "stn2/bn4")
        s = dbr(s, "stn2/fc2", "stn2/bn5")
        dim = x.shape[-1]
        trans = self.dense(s, p + "stn2/fc3").reshape(-1, dim, dim)
        trans = trans + torch.eye(dim, device=x.device)
        x = torch.matmul(self.q(x), self.q(trans).transpose(1, 2))
        x = dbr(x, "conv1", "bn1")
        x = dbr(x, "conv2", "bn2")
        x = self.bn(self.dense(x, p + "conv3"), p + "bn3")
        w = torch.softmax(self.dense(x, p + "att/fc_query"), dim=1)  # (Q, P, 1)
        return (w * self.dense(x, p + "att/fc_value")).sum(dim=1)

    def field(self, latents: Tensor, pts: Tensor, q: Tensor, block: int = 2048) -> Tensor:
        """softmax(logits)[0] - softmax(logits)[1] at queries q (Q, 3).

        The decoder reads each query's k nearest cloud points; PPSurf's
        patch is its P = num_pts_local nearest, as published, whether P is
        below k or above it (100NN, 200NN). One search a block at
        max(k, P) serves both: `knn` sorts stably, so its first k columns
        are the search at k, ties to the lower id. Both are cut to the
        cloud's N points where it has fewer."""
        n = pts.shape[0]
        k = min(self.c["k"], n)
        pk = min(self.c["num_pts_local"], n) if self.ppsurf else 0
        out = []
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block]
            ids = knn(pts, qb, max(k, pk))
            logits = self.decoder(latents, pts, qb, ids[:, :k])
            if self.ppsurf:
                patch = pts[ids[:, :pk]] - qb[:, None, :]
                radius = torch.linalg.vector_norm(patch, dim=-1).amax(dim=-1)
                patch = patch / torch.clamp(radius[:, None, None], min=1e-30)
                x = logits + self.pointnet(patch)
                for i in range(2):
                    x = torch.relu(self.bn(self.dense(x, f"mlp/fc{i}"), f"mlp/bn{i}"))
                logits = self.dense(x, "mlp/fc_final")
            probs = torch.softmax(logits, dim=-1)
            out.append(probs[:, 0] - probs[:, 1])
        return torch.cat(out)


# --- the encoder's partitions -------------------------------------------

def encoder_layout(n: int, chunk: int) -> typing.Tuple[int, int, int]:
    """(bucketed size nb, chunk size s, chunks a pass)."""
    s = min(chunk, n)
    nb = -(-n // BUCKET) * BUCKET if n > s else n
    return nb, s, -(-nb // s)


def encoder_draws(n: int, chunk: int, passes: int, generator: torch.Generator,
                  device: torch.device):
    """(perms (passes, nb), per chunk the four levels' (tie, rotation)
    uniforms), drawn in the inference path's order."""
    nb, s, num_chunks = encoder_layout(n, chunk)
    perms = torch.stack([torch.randperm(nb, generator=generator, device=device)
                         for _ in range(passes)])
    draws = []
    for _ in range(passes * num_chunks):
        sizes = [s] + level_sizes(s)
        draws.append([(torch.rand(sizes[lvl], generator=generator, device=device),
                       torch.rand(HALVINGS, 3, generator=generator, device=device))
                      for lvl in range(4)])
    return perms, draws


@torch.no_grad()
def encode(net: Plain, pts: Tensor, generator_seed: int) -> Tensor:
    """(N, latent) latents: each pass a random partition of the cloud
    (a permutation of the bucketed size, modulo N, the last chunk filled
    from its start), each chunk through the U-Net, every point's latents
    averaged over the chunks that held it."""
    c = net.c
    n = pts.shape[0]
    gen = torch.Generator(device=pts.device).manual_seed(generator_seed)
    nb, s, num_chunks = encoder_layout(n, c["gen_subsample_manifold"])
    perms, draws = encoder_draws(n, c["gen_subsample_manifold"],
                                 c["gen_subsample_manifold_iter"], gen, pts.device)
    perms = perms % n
    ids = torch.cat([perms, perms[:, : num_chunks * s - nb]], dim=1).reshape(-1, s)
    total = torch.zeros((n, c["network_latent_size"]), device=pts.device)
    count = torch.zeros((n,), device=pts.device)
    for chunk_ids, d in zip(ids, draws):
        total.index_add_(0, chunk_ids, net.encode_chunk(graph(pts[chunk_ids], d)))
        count.index_add_(0, chunk_ids, torch.ones_like(chunk_ids, dtype=torch.float32))
    return total / torch.clamp(count, min=1.0)[:, None]


@torch.no_grad()
def bisect(field: typing.Callable[[Tensor], Tensor], v: Tensor, v1: Tensor, v2: Tensor,
           p1: Tensor, p2: Tensor, iters: int) -> Tensor:
    """`iters` rounds of bisection of each vertex between its grid points
    v1 and v2, whose field values' signs are p1 and p2."""
    for _ in range(iters):
        f = field(v)
        m1 = (f * p1) > 0
        v1 = torch.where(m1[:, None], v, v1)
        p1 = torch.where(m1, f, p1)
        m2 = (f * p2) > 0
        v2 = torch.where(m2[:, None], v, v2)
        p2 = torch.where(m2, f, p2)
        v = 0.5 * (v1 + v2)
    return v
