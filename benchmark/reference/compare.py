"""The comparison that decides `correct` for reconstruction cells.

For each object checked (the window's last and others drawn from the
seed), the plain float32 reference (`plain.py`, TF32 off) works out again,
from the same cloud, weights and generator seed:

- `latent_gap`: the encoder's latents, max |program - reference| over
  every entry, over the reference's root mean square;
- `field_gap`: the field at the sampled grid queries the engine asked
  for, max |program - reference| (the field before any blend; it lies in
  [-1, 1]);
- `vertex_p90`: the sampled vertices' bisection from the same grid edges
  and the same signs at their ends: |program - reference| over the edge's
  length, its 90th percentile over the vertices. Not the largest: where
  the field is near nought along an edge, a sign that differs at one
  iterate sends the two bisections to different halves, so the largest
  gap reads 0.7-1.0 of an edge on every seed in sound runs and in the
  control alike (`vertex_gap`, reported beside it, not compared);
- `grid_sign`: the sampled voxels of the volume the grower handed
  marching cubes, where it holds a value: the share whose sign differs
  from the reference's field there;
- `corner_p90`: the corners of the sampled faces of the mesh returned:
  the distance to the reference's surface along the reference field's
  gradient, in grid edges and at most 1, its 90th percentile (the field
  as marching cubes sees it: past the grid's border voxels, which hold
  the out value +1, never inside);
- reported beside them, not compared (the control does not read three
  times the sound runs there; PERF.md gives the readings): `vertex_p99`;
  `face_far`, the sampled faces whose centre has no sign change of that
  field within half an edge along the normal; `unpaired_edges`, of the
  mesh's edges the share not shared by exactly two faces.

`limits/<cell>.json` names the numbers a cell compares. A candidate (the
program's recorded outputs, or the control's) is judged by `gaps`;
`numbers` judges the program.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from benchmark.reference import plain


def choose_objects(seed: int, n: int, k: int) -> typing.List[int]:
    """The last object and k - 1 others drawn from the seed."""
    rng = np.random.default_rng([int(seed) & (2**63 - 1), 11])
    others = rng.permutation(n - 1)[: max(0, k - 1)].tolist()
    return sorted(set(others + [n - 1]))


def blend_fn(cloud: np.ndarray, on: bool):
    """The mix's transform of the field as the reference applies it."""
    if not on:
        return lambda vals, q: vals
    radius = float(np.max(np.abs(cloud)))
    return lambda vals, q: 0.01 * vals + (torch.sqrt((q.float() ** 2).sum(-1)) - radius)


PADDING = 1  # the engine's padded border, in voxels
FACE_REACH = 0.5  # how far along a face's normal `face_far` looks, in grid edges


def grid_geometry(obj: dict) -> typing.Tuple[float, float, float, float]:
    """(bmin, bmax, step, bmin_pad) of the object's grid, worked out from
    its cloud and resolution as the engine lays its grid out."""
    bmin, bmax = float(obj["cloud"].min()), float(obj["cloud"].max())
    step = (bmax - bmin) / (int(obj["resolution"]) - 1)
    return bmin, bmax, step, bmin - PADDING * step


class Side:
    """One side's network on one object: latents, field, bisection."""

    def __init__(self, net: plain.Plain, cloud: torch.Tensor, latents: torch.Tensor,
                 blend, block: int = 2048):
        self.net, self.cloud, self.latents, self.blend = net, cloud, latents, blend
        self.block = block

    def field(self, q: torch.Tensor) -> torch.Tensor:
        return self.net.field(self.latents, self.cloud, q, block=self.block)

    def blended(self, q: torch.Tensor) -> torch.Tensor:
        return self.blend(self.field(q), q)

    def refine(self, r: dict, device) -> torch.Tensor:
        t = {k: torch.from_numpy(np.asarray(r[k], np.float32)).to(device)
             for k in ("v", "v1", "v2", "p1", "p2")}
        return plain.bisect(self.blended, t["v"], t["v1"], t["v2"], t["p1"], t["p2"],
                            r["iters"])


def raw_field(obj: dict, blend_on: bool, device) -> typing.Tuple[torch.Tensor, torch.Tensor]:
    """(queries, the program's field before the blend) of the sample."""
    q = torch.from_numpy(np.concatenate(obj["field_q"])).to(device)
    v = torch.from_numpy(np.concatenate(obj["field_v"])).to(device)
    if blend_on:  # undo 0.01 f + d(q): the same f32 distance, 100x its rounding
        radius = float(np.max(np.abs(obj["cloud"])))
        v = (v - (torch.sqrt((q ** 2).sum(-1)) - radius)) / 0.01
    return q, v


def gaps(cand: dict, ref: Side, obj: dict, device) -> typing.Dict[str, float]:
    """The numbers of a candidate: `latents` (N, L), `field` at the
    sample's queries (before the blend) and `refined` sample vertices."""
    lat_r = ref.latents
    rms = float(torch.sqrt((lat_r ** 2).mean()))
    latent_gap = float((cand["latents"].float() - lat_r).abs().max()) / rms
    q = cand["field_q"]
    field_gap = float((cand["field"] - ref.field(q)).abs().max())
    r = obj["refine"]
    out = torch.from_numpy(np.asarray(cand["refined"], np.float32)).to(device)
    v_ref = ref.refine(r, device)
    edge = torch.linalg.vector_norm(torch.from_numpy(r["v2"] - r["v1"]).to(device), dim=-1)
    rel = torch.linalg.vector_norm(out - v_ref, dim=-1) / edge
    p90, p99 = torch.quantile(rel.double(), torch.tensor([0.9, 0.99], dtype=torch.float64,
                                                         device=rel.device))
    return dict(latent_gap=latent_gap, field_gap=field_gap, vertex_p90=float(p90),
                vertex_gap=float(rel.max()), vertex_p99=float(p99),
                **mesh_gaps(cand, ref, obj, device))


def inside(ref: Side, q: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    """Where the reference's field as marching cubes sees it is under the
    level: the blended field, and past the grid's border voxels [lo, hi],
    which hold the out value, never."""
    return (ref.blended(q) < 0) & ~((q < lo) | (q > hi)).any(-1)


def unpaired_share(faces: np.ndarray) -> float:
    """The share of a face list's edges not shared by exactly two faces."""
    f = np.asarray(faces, np.int64)
    e = np.sort(np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(e[:, 0] * (int(f.max()) + 1) + e[:, 1], return_counts=True)
    return float((counts != 2).sum()) / counts.size


def mesh_gaps(cand: dict, ref: Side, obj: dict, device) -> typing.Dict[str, float]:
    """`grid_sign`, `corner_p90`, `face_far` and `unpaired_edges` of a
    candidate's `grid` ({ijk, values}), `faces_tri` (F, 3, 3) and
    `mesh_faces`."""
    bmin, bmax, step, bmin_pad = grid_geometry(obj)
    g = cand["grid"]
    q = torch.from_numpy(g["ijk"].astype(np.float32) * step + bmin_pad).to(device)
    cand_in = torch.from_numpy(g["values"]).to(device) < 0
    grid_sign = float((cand_in != (ref.blended(q) < 0)).double().mean())  # interior voxels
    lo, hi = bmin_pad, bmax + PADDING * step
    tri = torch.from_numpy(cand["faces_tri"]).to(device)
    c = tri.mean(1)
    n = torch.linalg.cross(tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0])
    n = n / torch.linalg.vector_norm(n, dim=-1, keepdim=True)
    a = inside(ref, c + FACE_REACH * step * n, lo, hi)
    b = inside(ref, c - FACE_REACH * step * n, lo, hi)
    corner = to_surface(ref, tri.reshape(-1, 3), step, lo, hi)
    return dict(grid_sign=grid_sign, corner_p90=float(torch.quantile(corner.double(), 0.9)),
                face_far=float((a == b).double().mean()),
                unpaired_edges=unpaired_share(cand["mesh_faces"]))


def to_surface(ref: Side, p: torch.Tensor, step: float, lo: float, hi: float,
               scan: int = 16, iters: int = 6) -> torch.Tensor:
    """The distance, in grid edges, from each point p to the reference's
    surface (as `inside` sees it) along the line through p in the
    direction of the reference field's gradient (central differences a
    twentieth of an edge wide), out to one edge on either side: the first
    change of side on a scan of `scan` steps a half, then `iters`
    bisections; 1 where neither half changes side (a gradient of nought,
    where the field saturates, changes nowhere). A scan and not the ends'
    signs alone: the field, a blend over nearest neighbours, can cross
    twice within an edge."""
    eye = torch.eye(3, dtype=p.dtype, device=p.device) * (0.05 * step)
    g = torch.stack([ref.blended(p + eye[i]) - ref.blended(p - eye[i]) for i in range(3)], -1)
    n = g / torch.linalg.vector_norm(g, dim=-1, keepdim=True) * step
    at0 = inside(ref, p, lo, hi)
    ts = torch.arange(1, scan + 1, dtype=p.dtype, device=p.device) / scan
    dist = torch.ones(p.shape[0], dtype=p.dtype, device=p.device)
    for sign in (1.0, -1.0):
        line = p[:, None, :] + sign * ts[None, :, None] * n[:, None, :]
        changed = inside(ref, line.reshape(-1, 3), lo, hi).reshape(-1, scan) != at0[:, None]
        first = changed.to(torch.uint8).argmax(1)
        t_out = ts[first]
        t_in = t_out - 1.0 / scan
        for _ in range(iters):
            mid = 0.5 * (t_in + t_out)
            same = inside(ref, p + sign * mid[:, None] * n, lo, hi) == at0
            t_in = torch.where(same, mid, t_in)
            t_out = torch.where(same, t_out, mid)
        dist = torch.where(changed.any(1), torch.minimum(dist, 0.5 * (t_in + t_out)), dist)
    return dist


def reference_side(config: dict, mix: dict, flat: dict, obj: dict, device,
                   q=lambda x: x) -> Side:
    """The reference (or, with a rounding `q`, the control) on one object."""
    plain.no_tf32()
    net = plain.Plain(flat, config, q)
    cloud = torch.from_numpy(obj["cloud"]).to(device)
    latents = plain.encode(net, cloud, obj["gen_seed"])
    return Side(net, cloud, latents, blend_fn(obj["cloud"], config.get("blend") == "sphere"))


MESH_KEYS = ("grid", "faces_tri", "mesh_faces")


def program_candidate(obj: dict, config: dict, device) -> dict:
    q, v = raw_field(obj, config.get("blend") == "sphere", device)
    return dict(latents=obj["latents"], field_q=q, field=v, refined=obj["refine"]["out"],
                **{k: obj[k] for k in MESH_KEYS})


def control_candidate(ctl: Side, obj: dict, config: dict, device, mesh: dict) -> dict:
    """The control in the program's place: its latents, its field at the
    program's sampled queries, its bisection from the same edges, and the
    sample (`MESH_KEYS`) of the volume and mesh that the engine built on
    its field (`harness/reconstruct.py::control_mesh`)."""
    q, _ = raw_field(obj, config.get("blend") == "sphere", device)
    with torch.no_grad():
        return dict(latents=ctl.latents, field_q=q, field=ctl.field(q),
                    refined=ctl.refine(obj["refine"], device).cpu().numpy(),
                    **{k: mesh[k] for k in MESH_KEYS})


@torch.no_grad()
def numbers(config: dict, mix: dict, flat: dict, objects: typing.Sequence[dict], device,
            log) -> typing.Dict[str, float]:
    """The program's numbers: the largest over the objects checked."""
    worst: typing.Dict[str, float] = {}
    for obj in objects:
        if (obj.get("refine") is None or not obj["field_q"]
                or any(obj.get(k) is None for k in MESH_KEYS)):  # nothing to judge
            return {}
        ref = reference_side(config, mix, flat, obj, device)
        g = gaps(program_candidate(obj, config, device), ref, obj, device)
        log("# checked object: " + " ".join(f"{k}={v:.6g}" for k, v in g.items()))
        for k, v in g.items():
            worst[k] = max(worst.get(k, 0.0), v) if np.isfinite(v) else float("inf")
        del ref
    return worst
