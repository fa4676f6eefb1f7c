"""Plain PyTorch reference of PPSurf training steps, in float32.

Written from the JAX package's training path as a pattern
(`ppsurf_tpu/train/{loop,model}.py`, `ppsurf_tpu/data/datasets.py`) and
importing none of it or of the program. From the dataset arrays and the
seeds the benchmark hands to both sides it works out again:

- each step's batch: the epoch's shuffle (a numpy generator on the
  loader's seed), each item's seed (the dataset's own numpy stream, drawn
  in batch order), the item's uniform rotation of cloud and queries and
  its manifold subsample, the raw cloud that the patches come from;
- each item's FKAConv graph (the four levels' subsampling draws from the
  step's torch generator), the decoder's k nearest ids and the P-point
  patches (k nearest over the raw cloud);
- the forward in train mode: BatchNorm on the batch's statistics, the
  FKAConv radius EMA taken before each layer uses it, dropout keep masks
  drawn from the same generator after the graph draws, the two-class
  cross-entropy; autograd's backward; one AdamW update (decoupled decay,
  bias-corrected moments).

`q` rounds every product's operands (the control's float8); in float32
it is the identity and TF32 is off.
"""
from __future__ import annotations

import math
import typing

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import plain

Tensor = torch.Tensor
NORM_RADIUS_MOMENTUM = 0.1
BN_EPS = 1e-5


# --- the loader's batches -------------------------------------------------

def rotation(rng: np.random.RandomState) -> np.ndarray:
    """(3, 3) uniform rotation from three uniforms (Shoemake)."""
    r1, r2, r3 = rng.rand(3)
    x = np.sqrt(1.0 - r1) * np.sin(2.0 * np.pi * r2)
    y = np.sqrt(1.0 - r1) * np.cos(2.0 * np.pi * r2)
    z = np.sqrt(r1) * np.sin(2.0 * np.pi * r3)
    w = np.sqrt(r1) * np.cos(2.0 * np.pi * r3)
    return np.array([[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
                     [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
                     [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]])


def make_item(shape: dict, seed: int, manifold_points: int) -> dict:
    """One augmented item: the rotated cloud and queries, the manifold
    subsample (with replacement where the cloud is smaller), occupancy
    from the distance's sign."""
    rng = np.random.RandomState(seed)
    rot = rotation(rng)
    raw = shape["pts"] @ rot.T + np.zeros(3)[None, :]
    queries = shape["queries"] @ rot.T + np.zeros(3)[None, :]
    n = raw.shape[0]
    choice = rng.choice(n, manifold_points, replace=n < manifold_points)
    return dict(pts=raw[choice].astype(np.float32), raw=raw.astype(np.float32),
                queries=queries.astype(np.float32), occ=(shape["dist"] > 0.0).astype(np.int64))


def batches(shapes: typing.Sequence[dict], batch_size: int, shuffle_seed: int, data_seed: int,
            manifold_points: int, steps: int) -> typing.List[typing.List[dict]]:
    """The first `steps` batches: epochs of shuffled whole batches (the
    order wrapped around to fill the last), each item's seed drawn from
    the dataset's stream in batch order."""
    order_rng = np.random.RandomState(shuffle_seed)
    data_rng = np.random.RandomState(data_seed)
    out: typing.List[typing.List[dict]] = []
    while len(out) < steps:
        order = np.arange(len(shapes))
        order_rng.shuffle(order)
        if len(order) % batch_size:
            order = np.concatenate([order, order[: batch_size - len(order) % batch_size]])
        for s in range(0, len(order), batch_size):
            idx = order[s:s + batch_size]
            seeds = [int(data_rng.randint(0, 2**31 - 1)) for _ in idx]
            out.append([make_item(shapes[i], sd, manifold_points) for i, sd in zip(idx, seeds)])
            if len(out) == steps:
                break
    return out


# --- the network in train mode ---------------------------------------------

def gather(values: Tensor, ids: Tensor) -> Tensor:
    """values (B, N, C), ids (B, M, K) -> (B, M, K, C)."""
    return values[torch.arange(values.shape[0], device=values.device)[:, None, None], ids]


class PlainTrain(plain.Plain):
    """PPSurf in train mode on a batch, on leaf tensors that require grad
    (`params`) and the radius buffers (`state`, updated in place)."""

    def __init__(self, params: typing.Dict[str, Tensor], state: typing.Dict[str, Tensor],
                 config: dict, q=lambda x: x):
        super().__init__({**params, **state}, config, q)
        self.state = state

    def bn(self, x: Tensor, path: str) -> Tensor:
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(dim=axes)
        var = x.var(dim=axes, unbiased=False)
        inv = self.p(path + "/scale") * torch.rsqrt(var + BN_EPS)
        return x * inv + (self.p(path + "/bias") - mean * inv)

    def inorm(self, x: Tensor, path: str) -> Tensor:  # (B, M, K, C): per item
        axes = tuple(range(1, x.dim() - 1))
        mean = x.mean(dim=axes, keepdim=True)
        var = x.var(dim=axes, keepdim=True, unbiased=False)
        return self.affine((x - mean) / torch.sqrt(var + BN_EPS), path)

    def fkaconv(self, x, pts, sup, ids, path):
        local = gather(pts, ids) - sup[:, :, None, :]  # (B, M, K, 3)
        with torch.no_grad():
            ld = local.detach()
            dist = torch.sqrt(torch.clamp((ld * ld).sum(-1), min=0.0))
            key = f"batch_stats/{path}/norm_radius"
            self.state[key] = (self.state[key] * (1.0 - NORM_RADIUS_MOMENTUM)
                               + dist.amax(dim=2).mean() * NORM_RADIUS_MOMENTUM)
        local = local / self.state[key]
        dw = torch.sigmoid(-self.p(path + "/alpha") * dist + self.p(path + "/beta"))
        dw_sum = dw.sum(dim=2, keepdim=True)
        dw_sum = dw_sum + (dw_sum == 0.0).float() + 1e-6
        dw = (dw / dw_sum * dist.shape[2])[..., None]
        k = ids.shape[-1]
        mat = self.dense(local, path + "/fc1")
        mat = self.act(mat if k == 1 else self.inorm(mat, path + "/bn1"))
        mat = torch.cat([mat, (mat * dw).amax(dim=2, keepdim=True).expand_as(mat)], -1)
        mat = self.dense(mat, path + "/fc2")
        mat = self.act(mat if k == 1 else self.inorm(mat, path + "/bn2"))
        mat = torch.cat([mat, (mat * dw).amax(dim=2, keepdim=True).expand_as(mat)], -1)
        mat = self.act(self.dense(mat, path + "/fc3")) * dw
        feats = torch.einsum("bmkc,bmkj->bmcj", self.q(gather(x, ids)), self.q(mat))
        b, m = feats.shape[:2]
        cv = self.p(path + "/cv")
        return self.q(feats.reshape(b, m, -1)) @ self.q(cv.reshape(-1, cv.shape[-1]))

    def resblock(self, x, pts, sup, ids, path):
        h = torch.relu(self.bn(self.dense(x, path + "/cv0"), path + "/bn0"))
        h = self.fkaconv(h, pts, sup, ids, path + "/cv1")
        h = torch.relu(self.bn(h, path + "/bn1"))
        h = self.bn(self.dense(h, path + "/cv2"), path + "/bn2")
        short = x
        if f"params/{path}/shortcut/kernel" in self.W:
            short = self.bn(self.dense(x, path + "/shortcut"), path + "/bn_shortcut")
        if short.shape[1] != h.shape[1]:  # the first maximum carries the gradient
            g = gather(short, ids)
            short = torch.gather(g, 2, g.argmax(dim=2, keepdim=True))[:, :, 0, :]
        return torch.relu(h + short)

    def encode(self, g: typing.Dict[str, Tensor]) -> Tensor:
        """(B, N, latent) of the batch's graphs (`graph` keys, batched)."""
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
        x5 = x4.amax(dim=1, keepdim=True).expand_as(x4)
        up = torch.relu(self.bn(self.dense(torch.cat([x4, x5], -1), e + "cv5"), e + "bn5"))
        for ids, skip, name in ((g["ids43"], x3, "3d"), (g["ids32"], x2, "2d"),
                                (g["ids21"], x1, "1d"), (g["ids10"], x0, "0d")):
            up = torch.cat([gather(up, ids)[:, :, 0, :], skip], -1)
            up = torch.relu(self.bn(self.dense(up, e + "cv" + name), e + "bn" + name))
        return self.dense(up, e + "fcout")

    def logits(self, data: typing.Dict[str, Tensor], masks: typing.Sequence[Tensor]) -> Tensor:
        latents = self.encode(data)
        pts, q, ids = data["s0"], data["queries"], data["proj_ids"]
        d = "projection/"
        rel = q[:, :, None, :] - gather(pts, ids)
        x = torch.relu(self.dense(torch.cat([gather(latents, ids), rel], -1), d + "fc1"))
        x = torch.relu(self.dense(x, d + "fc2"))
        x = torch.relu(self.dense(x, d + "fc3"))
        att = torch.softmax(self.dense(x, d + "fc_query"), dim=2).mean(dim=-1)
        feat = self.dense((att[..., None] * self.dense(x, d + "fc_value")).sum(dim=2), d + "fc8")
        b, nq, lat = feat.shape
        feat = feat + self.pointnet(data["patches"].reshape(b * nq, -1, 3)).reshape(b, nq, lat)
        x = feat.reshape(b * nq, lat)
        keep = 1.0 - self.c["dropout"]
        for i in range(2):
            x = torch.relu(self.bn(self.dense(x, f"mlp/fc{i}"), f"mlp/bn{i}"))
            x = torch.where(masks[i], x / keep, torch.zeros_like(x))
        return self.dense(x, "mlp/fc_final").reshape(b, nq, -1)


# --- the step ---------------------------------------------------------------

def step_data(batch: typing.Sequence[dict], config: dict, generator: torch.Generator,
              device) -> typing.Dict[str, Tensor]:
    """The network's inputs of a step: each item's graph from its draws
    (drawn item by item from `generator`), the decoder's k nearest ids
    into the subsample and the patches of the P nearest raw points."""
    graphs = []
    for it in batch:
        pts = torch.from_numpy(it["pts"]).to(device)
        n = pts.shape[0]
        sizes = [n] + plain.level_sizes(n)
        draws = [(torch.rand(sizes[lvl], generator=generator, device=device),
                  torch.rand(plain.HALVINGS, 3, generator=generator, device=device))
                 for lvl in range(4)]
        g = plain.graph(pts, draws)
        q = torch.from_numpy(it["queries"]).to(device)
        raw = torch.from_numpy(it["raw"]).to(device)
        g["queries"] = q
        g["proj_ids"] = plain.knn(pts, q, config["k"])
        patch = raw[plain.knn(raw, q, config["num_pts_local"])] - q[:, None, :]
        radius = torch.linalg.vector_norm(patch, dim=-1).amax(dim=-1)
        g["patches"] = patch / torch.clamp(radius[:, None, None], min=1e-30)
        g["occ"] = torch.from_numpy(it["occ"]).to(device)
        graphs.append(g)
    return {k: torch.stack([g[k] for g in graphs]) for k in graphs[0]}


class AdamW:
    """torch.optim.AdamW's update: p(1 - lr wd), then the bias-corrected
    Adam step; every moment in float32."""

    def __init__(self, params: typing.Dict[str, Tensor], lr: float, wd: float,
                 betas=(0.9, 0.999), eps: float = 1e-5):
        self.lr, self.wd, self.b1, self.b2, self.eps = lr, wd, betas[0], betas[1], eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: typing.Dict[str, Tensor], grads: typing.Dict[str, Tensor]) -> None:
        self.t += 1
        c1, c2 = 1.0 - self.b1 ** self.t, 1.0 - self.b2 ** self.t
        for k, p in params.items():
            g = grads[k]
            p.mul_(1.0 - self.lr * self.wd)
            self.m[k].mul_(self.b1).add_(g, alpha=1.0 - self.b1)
            self.v[k].mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
            denom = self.v[k].sqrt() / math.sqrt(c2) + self.eps
            p.addcdiv_(self.m[k], denom, value=-self.lr / c1)


def train_steps(flat: typing.Dict[str, Tensor], config: dict, step_batches, gen_seed: int,
                lr: float, wd: float, device, q=lambda x: x, half_batch: bool = False
                ) -> dict:
    """Run the steps from the initial weights `flat`: each step's loss,
    the first step's gradient of every parameter, the parameters after
    the last step. `half_batch` is the fault that takes the loss's mean
    over the first half of the batch only."""
    plain.no_tf32()
    params = {k: v.detach().clone().requires_grad_(True) for k, v in flat.items()
              if k.startswith("params/")}
    state = {k: v.detach().clone() for k, v in flat.items() if k.endswith("norm_radius")}
    opt = AdamW(params, lr, wd)
    gen = torch.Generator(device=device).manual_seed(gen_seed)
    losses, first_grad = [], None
    for batch in step_batches:
        data = step_data(batch, config, gen, device)
        b, nq = data["queries"].shape[:2]
        lat = config["network_latent_size"]
        keep = 1.0 - config["dropout"]
        masks = [torch.rand((b * nq, lat), generator=gen, device=device) < keep
                 for _ in range(2)]
        net = PlainTrain(params, state, config, q)
        logits = net.logits(data, masks)
        occ = data["occ"]
        if half_batch:
            logits, occ = logits[: b // 2], occ[: b // 2]
        loss = F.cross_entropy(logits.reshape(-1, 2), occ.reshape(-1))
        grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if first_grad is None:
            first_grad = {k: g.detach().clone() for k, g in grads.items()}
        opt.step(params, grads)
        losses.append(float(loss.detach()))
        del data, logits, loss, grads, net
    return dict(losses=losses, first_grad=first_grad,
                params={k: v.detach() for k, v in params.items()})
