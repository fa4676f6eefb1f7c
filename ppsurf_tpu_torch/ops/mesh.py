"""Meshing of the grown volume on the card: marching cubes, the vertex
merge, the degenerate and duplicate face removal and the small-component
filter (`recon/engine.py::reconstruct_mesh`'s `mesh` and `clean` phases on
the card route).

Contract: the mesh `mesh_volume` and `clean` return equals, vertex bits
and face order, what the host route returns for the same input
(`recon/marching_cubes.py::marching_cubes` through the native
`mc_extract`, then `recon/mesh_ops.py::clean_simple` and
`remove_small_connected_components`); `marching_cubes` equals
`mc_extract`'s vertices and faces, numbering included.

The kernels (`csrc/mesh.cu`) replace no TPU kernel: the JAX package
meshes on the host as the port's host route does. What bounds them is
bytes (the source's note): a few passes over the (R+2)^3 float64 volume,
139 MB at res 257, and a few MB of mesh rows. The volume's copy to the
card is the floor of the `mesh` phase.

The steps, each a kernel for CUDA tensors and its plain PyTorch version
for CPU tensors (`*_plain`, which the CPU tests hold against the host
route); scans (`torch.cumsum`) and sorts (`torch.sort`) sit between them
on either device:

1. `classify`: each cell's cube index and triangle count (0 where a
   corner is NaN), and the volume's least and greatest finite value (the
   engine's test that the field crosses the level);
2. `edges`: which of a grid point's three owned edges carry a vertex (cut,
   and in a cell with triangles), and how many;
3. `emit`: the vertices (mc_extract's float64 interpolation, rounded once
   to float32) at an exclusive scan of the edge counts, the faces at an
   exclusive scan of the triangle counts (cell-linear order, the host's
   face order), and each vertex's first position in the face list, whose
   order is the host's vertex numbering (first appearance);
4. `round_keys`: `np.round(vertices, 10)` bit for bit, -0 as +0; three
   stable sorts by z, y and x from the host's numbering give the
   lexicographic order with ties in host order, so a group's leader is its
   lowest host index, as `mesh_ops._unique_rows` takes it;
5. `runs`, `groups`: each group's rows and leader (vertices in group
   order, as the host's merge leaves them);
6. `face_keys`, `dedup`: faces through the merge; a face lives where it
   has no repeated vertex and is the first of its sorted vertex triple
   (one int64 key below 2^21 vertices, else two, sorted stably);
7. `components`: faces joined where they share an edge (union-find), the
   living faces counted a component, faces kept in components of more than
   `min_faces`, and the vertices they use;
8. `compact`: the kept faces in order, renumbered to the used vertices.
"""
from __future__ import annotations

import dataclasses
import typing

import numpy as np
import torch

from ppsurf_tpu_torch.ops import kernels

MAX_BLOCKS = 132 * 32  # `csrc/mesh.cu`'s MAX_BLOCKS: the classify kernel's partials
KEY_NONE = 2**63 - 1  # the key of a removed face or edge
ONE_KEY_VERTICES = 2**21  # below it a face's sorted vertex triple packs into one int64
INT64_MAX = 2**63 - 1
MAX_ROWS = 2**31 - 1  # `csrc/mesh.cu`'s kernels over mesh rows index them in int
POPC3 = (0, 1, 1, 2, 1, 2, 2, 3)  # set bits of a 3-bit edge mask

_TABLES: typing.Dict[torch.device, torch.Tensor] = {}


def table_block() -> np.ndarray:
    """The int8 tables of `csrc/mesh.cu`, from `recon/marching_cubes.py`'s
    generated ones: TRI (256 x 16 local edges, -1 padded), COUNTS (256),
    EDGE (12 x base corner offset and axis), CORNER (8 x offset)."""
    from ppsurf_tpu_torch.recon.marching_cubes import _CORNERS, _EDGES, _TRI_COUNTS, _TRI_TABLE

    tri = np.full((256, 16), -1, np.int8)
    tri[:, :15] = _TRI_TABLE
    edge = np.zeros((12, 4), np.int8)
    for e, (a, b) in enumerate(_EDGES):
        ca, cb = _CORNERS[a], _CORNERS[b]
        edge[e, :3] = np.minimum(ca, cb)
        edge[e, 3] = int(np.nonzero(cb - ca)[0][0])
    return np.concatenate([tri.reshape(-1), _TRI_COUNTS.astype(np.int8), edge.reshape(-1),
                           _CORNERS.astype(np.int8).reshape(-1)])


def tables(device: torch.device) -> torch.Tensor:
    """`table_block` on `device`, uploaded once."""
    t = _TABLES.get(device)
    if t is None:
        t = _TABLES[device] = torch.from_numpy(table_block()).to(device)
    return t


def _table_parts(tab: torch.Tensor):
    """(tri (256, 16), counts (256,), edge (12, 4), corner (8, 3)) as int64."""
    t = tab.long()
    return (t[:4096].view(256, 16), t[4096:4352], t[4352:4400].view(12, 4),
            t[4400:4424].view(8, 3))


def _coords(p: torch.Tensor, ny: int, nz: int) -> torch.Tensor:
    """(M, 3) grid coordinates of linear point indices."""
    return torch.stack([p // (ny * nz), (p // nz) % ny, p % nz], 1)


# ---------------------------------------------------------------------------
# 1. classify
# ---------------------------------------------------------------------------

def classify_plain(volume: torch.Tensor, level: float):
    """Plain version of `classify`."""
    nx, ny, nz = volume.shape
    tri, counts, _, corner = _table_parts(tables(volume.device))
    inside = volume < level
    cfg = torch.zeros((nx, ny, nz), dtype=torch.int64)
    valid = torch.zeros((nx, ny, nz), dtype=torch.bool)
    c = cfg[:-1, :-1, :-1]
    ok = torch.ones((nx - 1, ny - 1, nz - 1), dtype=torch.bool)
    nan = torch.isnan(volume)
    for bit, (cx, cy, cz) in enumerate(corner.tolist()):
        c |= inside[cx:cx + nx - 1, cy:cy + ny - 1, cz:cz + nz - 1].long() << bit
        ok &= ~nan[cx:cx + nx - 1, cy:cy + ny - 1, cz:cz + nz - 1]
    valid[:-1, :-1, :-1] = ok
    ntri = torch.where(valid, counts[cfg], 0).to(torch.int32)
    fin = volume[torch.isfinite(volume)]
    lohi = (torch.stack([fin.min(), fin.max()]) if fin.numel()
            else torch.tensor([float("inf"), float("-inf")], dtype=torch.float64))
    return cfg.to(torch.uint8).reshape(-1), ntri.reshape(-1), lohi


def classify(volume: torch.Tensor, level: float):
    """(cube index (N,) uint8, triangle count (N,) int32, (least, greatest)
    finite value (2,) float64) of a (nx, ny, nz) float64 volume; a cell
    sits at its origin point, and points that start no cell hold 0."""
    if volume.device.type == "cpu":
        return classify_plain(volume, level)
    vol = volume.contiguous()
    kernels.check_cuda_args("mesh_classify", {"volume": vol}, {"volume": torch.float64})
    nx, ny, nz = vol.shape
    dev = vol.device
    cfg = torch.empty(vol.numel(), dtype=torch.uint8, device=dev)
    ntri = torch.empty(vol.numel(), dtype=torch.int32, device=dev)
    partial = torch.tensor([float("inf"), float("-inf")], dtype=torch.float64,
                           device=dev).repeat(MAX_BLOCKS)
    kernels.launch("mesh_classify", "ppsurf_mesh_classify", dev, kernels.ptr(vol), nx, ny, nz,
                   float(level), kernels.ptr(tables(dev)), kernels.ptr(cfg), kernels.ptr(ntri),
                   kernels.ptr(partial))
    partial = partial.view(MAX_BLOCKS, 2)
    return cfg, ntri, torch.stack([partial[:, 0].min(), partial[:, 1].max()])


# ---------------------------------------------------------------------------
# 2. edges
# ---------------------------------------------------------------------------

def _shift(t: torch.Tensor, axis: int) -> torch.Tensor:
    """t moved one step up `axis` (out[i] = t[i - 1], False at 0)."""
    out = torch.zeros_like(t)
    src = [slice(None)] * 3
    dst = [slice(None)] * 3
    src[axis], dst[axis] = slice(None, -1), slice(1, None)
    out[tuple(dst)] = t[tuple(src)]
    return out


def edges_plain(volume: torch.Tensor, ntri: torch.Tensor, level: float):
    """Plain version of `edges`."""
    nx, ny, nz = volume.shape
    inside = volume < level
    has = (ntri > 0).view(nx, ny, nz)
    mask = torch.zeros((nx, ny, nz), dtype=torch.int64)
    for a in range(3):
        # the cells holding edge (p, a): p moved down the two other axes
        u, w = [b for b in range(3) if b != a]
        cells = has | _shift(has, u) | _shift(has, w) | _shift(_shift(has, u), w)
        cut = torch.zeros_like(inside)
        lo = [slice(None)] * 3
        hi = [slice(None)] * 3
        lo[a], hi[a] = slice(None, -1), slice(1, None)
        cut[tuple(lo)] = inside[tuple(lo)] != inside[tuple(hi)]
        mask |= (cut & cells).long() << a
    mask = mask.reshape(-1)
    count = torch.tensor(POPC3)[mask].to(torch.int32)
    return mask.to(torch.uint8), count


def edges(volume: torch.Tensor, ntri: torch.Tensor, level: float):
    """(edge mask (N,) uint8, bit a for the edge towards +axis a; its bit
    count (N,) int32): the grid edges that carry a vertex."""
    if volume.device.type == "cpu":
        return edges_plain(volume, ntri, level)
    vol = volume.contiguous()
    kernels.check_cuda_args("mesh_edges", {"volume": vol, "ntri": ntri},
                            {"volume": torch.float64, "ntri": torch.int32})
    nx, ny, nz = vol.shape
    dev = vol.device
    emask = torch.empty(vol.numel(), dtype=torch.uint8, device=dev)
    ecount = torch.empty(vol.numel(), dtype=torch.int32, device=dev)
    kernels.launch("mesh_edges", "ppsurf_mesh_edges", dev, kernels.ptr(vol), kernels.ptr(ntri),
                   nx, ny, nz, float(level), kernels.ptr(emask), kernels.ptr(ecount))
    return emask, ecount


# ---------------------------------------------------------------------------
# 3. emit
# ---------------------------------------------------------------------------

def emit_plain(volume, cfg, ntri, foff, emask, vbase, level, n_verts, n_faces):
    """Plain version of `emit`."""
    nx, ny, nz = volume.shape
    v = volume.reshape(-1)
    stride = (ny * nz, nz, 1)
    popc = torch.tensor(POPC3)
    em = emask.long()
    first_id = vbase.long() - popc[em]
    verts = torch.empty((n_verts, 3), dtype=torch.float32)
    for a in range(3):
        p = torch.nonzero((em >> a) & 1).squeeze(1)
        ids = first_id[p] + popc[em[p] & ((1 << a) - 1)]
        v0 = v[p]
        denom = v[p + stride[a]] - v0
        t = torch.where(denom.abs() > 1e-300, (level - v0) / denom, 0.5)
        t = torch.where(0.0 < t, t, 0.0)  # std::max(0.0, t), NaN to 0
        t = torch.where(t < 1.0, t, 1.0)  # std::min(1.0, t)
        c = _coords(p, ny, nz).double()
        c[:, a] = c[:, a] + t
        verts[ids] = c.float()
    tri, _, edge, _ = _table_parts(tables(volume.device))
    cells = torch.nonzero(ntri).squeeze(1)  # cell-linear order: the faces' order
    nt = ntri[cells].long()
    local = tri[cfg[cells].long(), :15]
    local = local[torch.arange(15) < 3 * nt[:, None]]  # (3F,) row by row
    point = torch.repeat_interleave(cells, 3 * nt)
    q = point + edge[local, 0] * stride[0] + edge[local, 1] * stride[1] + edge[local, 2]
    axis = edge[local, 3]
    ids = first_id[q] + popc[em[q] & ((1 << axis) - 1)]
    fp = torch.full((n_verts,), INT64_MAX, dtype=torch.int64).scatter_reduce(
        0, ids, torch.arange(3 * n_faces), "amin")
    return verts, ids.view(n_faces, 3), fp


def emit(volume, cfg, ntri, foff, emask, vbase, level, n_verts: int, n_faces: int):
    """(vertices (V, 3) float32, faces (F, 3) int64, each vertex's first
    position in the flat face list (V,) int64). foff and vbase are the
    inclusive scans (int64) of the triangle and edge counts."""
    if volume.device.type == "cpu":
        return emit_plain(volume, cfg, ntri, foff, emask, vbase, level, n_verts, n_faces)
    vol = volume.contiguous()
    kernels.check_cuda_args("mesh_emit", {"volume": vol, "cfg": cfg, "ntri": ntri, "foff": foff,
                                          "emask": emask, "vbase": vbase},
                            {"volume": torch.float64, "cfg": torch.uint8, "ntri": torch.int32,
                             "foff": torch.int64, "emask": torch.uint8, "vbase": torch.int64})
    nx, ny, nz = vol.shape
    dev = vol.device
    verts = torch.empty((n_verts, 3), dtype=torch.float32, device=dev)
    faces = torch.empty((n_faces, 3), dtype=torch.int64, device=dev)
    fp = torch.full((n_verts,), INT64_MAX, dtype=torch.int64, device=dev)
    kernels.launch("mesh_emit", "ppsurf_mesh_emit", dev, kernels.ptr(vol), kernels.ptr(cfg),
                   kernels.ptr(ntri), kernels.ptr(foff), kernels.ptr(emask), kernels.ptr(vbase),
                   nx, ny, nz, float(level), kernels.ptr(tables(dev)), kernels.ptr(verts),
                   kernels.ptr(faces), kernels.ptr(fp))
    return verts, faces, fp


# ---------------------------------------------------------------------------
# 4.-5. the vertex merge
# ---------------------------------------------------------------------------

def round_keys_plain(verts: torch.Tensor) -> torch.Tensor:
    """Plain version of `round_keys` (a divisor of full size: no scalar
    path may turn the division into a product)."""
    y = torch.round(verts.double() * 1e10)
    return y / torch.full_like(y, 1e10) + 0.0


def round_keys(verts: torch.Tensor) -> torch.Tensor:
    """`np.round(float64(verts), 10)` bit for bit, -0 as +0: (V, 3) float64."""
    if verts.device.type == "cpu":
        return round_keys_plain(verts)
    v = verts.contiguous()
    kernels.check_cuda_args("mesh_round_keys", {"verts": v}, {"verts": torch.float32})
    keys = torch.empty(v.shape, dtype=torch.float64, device=v.device)
    kernels.launch("mesh_round_keys", "ppsurf_mesh_round_keys", v.device, kernels.ptr(v),
                   v.numel(), kernels.ptr(keys))
    return keys


def runs_plain(keys: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """Plain version of `runs`."""
    ks = keys[perm]
    start = torch.ones(perm.shape[0], dtype=torch.int32)
    start[1:] = (ks[1:] != ks[:-1]).any(1).to(torch.int32)
    return start


def runs(keys: torch.Tensor, perm: torch.Tensor) -> torch.Tensor:
    """(V,) int32: 1 where sorted row j (key row perm[j]) starts a group."""
    if keys.device.type == "cpu":
        return runs_plain(keys, perm)
    kernels.check_cuda_args("mesh_runs", {"keys": keys, "perm": perm},
                            {"keys": torch.float64, "perm": torch.int64})
    start = torch.empty(perm.shape[0], dtype=torch.int32, device=keys.device)
    kernels.launch("mesh_runs", "ppsurf_mesh_runs", keys.device, kernels.ptr(keys),
                   kernels.ptr(perm), perm.shape[0], kernels.ptr(start))
    return start


def groups_plain(perm: torch.Tensor, start: torch.Tensor, gid: torch.Tensor):
    """Plain version of `groups`."""
    g = gid.long() - 1
    inverse = torch.empty_like(perm)
    inverse[perm] = g
    leader = torch.zeros_like(perm)
    s = start.bool()
    leader[g[s]] = perm[s]
    return inverse, leader


def groups(perm: torch.Tensor, start: torch.Tensor, gid: torch.Tensor):
    """(each row's group (V,) int64, each group's leader row (V,) int64,
    valid for the first gid[-1] groups); gid is the inclusive scan of
    `start`."""
    if perm.device.type == "cpu":
        return groups_plain(perm, start, gid)
    kernels.check_cuda_args("mesh_groups", {"perm": perm, "start": start, "gid": gid},
                            {"perm": torch.int64, "start": torch.int32, "gid": torch.int32})
    inverse = torch.empty_like(perm)
    leader = torch.empty_like(perm)
    kernels.launch("mesh_groups", "ppsurf_mesh_groups", perm.device, kernels.ptr(perm),
                   kernels.ptr(start), kernels.ptr(gid), perm.shape[0], kernels.ptr(inverse),
                   kernels.ptr(leader))
    return inverse, leader


# ---------------------------------------------------------------------------
# 6. degenerate and duplicate faces
# ---------------------------------------------------------------------------

def face_keys_plain(faces: torch.Tensor, inverse: torch.Tensor, nv: int, two: bool):
    """Plain version of `face_keys`."""
    mf = inverse[faces]
    lo, mid, hi = mf.sort(1).values.unbind(1)
    degenerate = (mf[:, 0] == mf[:, 1]) | (mf[:, 1] == mf[:, 2]) | (mf[:, 0] == mf[:, 2])
    if two:
        return (mf, torch.where(degenerate, KEY_NONE, lo * nv + mid),
                torch.where(degenerate, KEY_NONE, hi))
    return mf, torch.where(degenerate, KEY_NONE, (lo * nv + mid) * nv + hi), None


def face_keys(faces: torch.Tensor, inverse: torch.Tensor, nv: int, two: bool):
    """(faces through the merge (F, 3) int64, key 1 (F,), key 2 (F,) or
    None): the sorted vertex triple as (lo * nv + mid) * nv + hi, or with
    `two` as lo * nv + mid and hi; KEY_NONE where a vertex repeats."""
    if faces.device.type == "cpu":
        return face_keys_plain(faces, inverse, nv, two)
    f = faces.contiguous()
    kernels.check_cuda_args("mesh_face_keys", {"faces": f, "inverse": inverse},
                            {"faces": torch.int64, "inverse": torch.int64})
    nf = f.shape[0]
    mf = torch.empty_like(f)
    k1 = torch.empty(nf, dtype=torch.int64, device=f.device)
    k2 = torch.empty(nf, dtype=torch.int64, device=f.device) if two else None
    kernels.launch("mesh_face_keys", "ppsurf_mesh_face_keys", f.device, kernels.ptr(f),
                   kernels.ptr(inverse), nf, nv, int(two), kernels.ptr(mf), kernels.ptr(k1),
                   kernels.ptr(k2))
    return mf, k1, k2


def dedup_plain(k1, k2, p, mf, nv: int):
    """Plain version of `dedup`."""
    a1 = k1[p]
    first = torch.ones(p.shape[0], dtype=torch.bool)
    first[1:] = a1[1:] != a1[:-1]
    if k2 is not None:
        a2 = k2[p]
        first[1:] |= a2[1:] != a2[:-1]
    alive = torch.zeros(p.shape[0], dtype=torch.uint8)
    alive[p] = (first & (a1 != KEY_NONE)).to(torch.uint8)
    nxt = mf[:, [1, 2, 0]]
    ekey = torch.where(alive.bool()[:, None],
                       torch.minimum(mf, nxt) * nv + torch.maximum(mf, nxt), KEY_NONE)
    return alive, ekey.reshape(-1)


def dedup(k1, k2, p, mf, nv: int):
    """(alive (F,) uint8, edge keys (3F,) int64): a face lives where its
    key is not KEY_NONE and it is the first of its key in the stable order
    `p`; its edges (v_e, v_e+1) key as lo * nv + hi, a removed face's as
    KEY_NONE."""
    if k1.device.type == "cpu":
        return dedup_plain(k1, k2, p, mf, nv)
    kernels.check_cuda_args("mesh_dedup", {"k1": k1, "p": p, "mf": mf},
                            {"k1": torch.int64, "p": torch.int64, "mf": torch.int64})
    nf = k1.shape[0]
    alive = torch.empty(nf, dtype=torch.uint8, device=k1.device)
    ekey = torch.empty(3 * nf, dtype=torch.int64, device=k1.device)
    kernels.launch("mesh_dedup", "ppsurf_mesh_dedup", k1.device, kernels.ptr(k1),
                   kernels.ptr(k2), kernels.ptr(p), kernels.ptr(mf), nf, nv,
                   kernels.ptr(alive), kernels.ptr(ekey))
    return alive, ekey


# ---------------------------------------------------------------------------
# 7. components
# ---------------------------------------------------------------------------

def components_plain(ekey, eidx, mf, alive, nv: int, min_faces: int):
    """Plain version of `components`: the union-find's partition by
    hooking pairs' labels to the smaller and following labels to their
    end, until no pair joins two labels."""
    nf = alive.shape[0]
    same = (ekey[1:] == ekey[:-1]) & (ekey[1:] != KEY_NONE)
    a = eidx[1:][same] // 3
    b = eidx[:-1][same] // 3
    root = torch.arange(nf)
    while True:
        ra, rb = root[a], root[b]
        hooked = root.scatter_reduce(0, torch.maximum(ra, rb), torch.minimum(ra, rb), "amin")
        while True:
            nxt = hooked[hooked]
            if torch.equal(nxt, hooked):
                break
            hooked = nxt
        if torch.equal(hooked, root):
            break
        root = hooked
    live = alive.bool()
    count = torch.bincount(root[live], minlength=nf)
    keep = live & (count[root] > min_faces)
    used = torch.zeros(nv, dtype=torch.int32)
    used[mf[keep].reshape(-1)] = 1
    return root.to(torch.int32), keep.to(torch.int32), used


def components(ekey, eidx, mf, alive, nv: int, min_faces: int):
    """(each face's root (F,) int32, its component's smallest face; keep
    (F,) int32; used vertices (nv,) int32) from the sorted edge keys and
    their positions 3 f + e: faces are kept where they live and their
    component has more than `min_faces` living faces."""
    if ekey.device.type == "cpu":
        return components_plain(ekey, eidx, mf, alive, nv, min_faces)
    kernels.check_cuda_args("mesh_components",
                            {"ekey": ekey, "eidx": eidx, "mf": mf, "alive": alive},
                            {"ekey": torch.int64, "eidx": torch.int64, "mf": torch.int64,
                             "alive": torch.uint8})
    nf = alive.shape[0]
    dev = ekey.device
    parent = torch.arange(nf, dtype=torch.int32, device=dev)
    count = torch.zeros(nf, dtype=torch.int32, device=dev)
    keep = torch.empty(nf, dtype=torch.int32, device=dev)
    used = torch.zeros(nv, dtype=torch.int32, device=dev)
    kernels.launch("mesh_components", "ppsurf_mesh_components", dev, kernels.ptr(ekey),
                   kernels.ptr(eidx), kernels.ptr(mf), kernels.ptr(alive), nf, int(min_faces),
                   kernels.ptr(parent), kernels.ptr(count), kernels.ptr(keep), kernels.ptr(used))
    return parent, keep, used


# ---------------------------------------------------------------------------
# 8. compact
# ---------------------------------------------------------------------------

def compact_plain(mf, keep, fpos, vpos, verts, leader, used, ng: int, nf_out: int, nv_out: int):
    """Plain version of `compact`."""
    faces = vpos.long()[mf[keep.bool()]] - 1
    return verts[leader[:ng][used[:ng].bool()]], faces


def compact(mf, keep, fpos, vpos, verts, leader, used, ng: int, nf_out: int, nv_out: int):
    """(the used groups' leaders' vertices (nv_out, 3) float32, the kept
    faces (nf_out, 3) int64 over them); fpos and vpos are the inclusive
    scans of keep and used."""
    if mf.device.type == "cpu":
        return compact_plain(mf, keep, fpos, vpos, verts, leader, used, ng, nf_out, nv_out)
    kernels.check_cuda_args("mesh_compact", {"mf": mf, "keep": keep, "fpos": fpos, "vpos": vpos,
                                             "verts": verts, "leader": leader, "used": used},
                            {"mf": torch.int64, "keep": torch.int32, "fpos": torch.int32,
                             "vpos": torch.int32, "verts": torch.float32,
                             "leader": torch.int64, "used": torch.int32})
    dev = mf.device
    faces = torch.empty((nf_out, 3), dtype=torch.int64, device=dev)
    out = torch.empty((nv_out, 3), dtype=torch.float32, device=dev)
    kernels.launch("mesh_compact", "ppsurf_mesh_compact", dev, kernels.ptr(mf), kernels.ptr(keep),
                   kernels.ptr(fpos), kernels.ptr(vpos), mf.shape[0], kernels.ptr(verts),
                   kernels.ptr(leader), kernels.ptr(used), ng, kernels.ptr(faces),
                   kernels.ptr(out))
    return out, faces


# ---------------------------------------------------------------------------
# the pipelines
# ---------------------------------------------------------------------------

def check_rows(nv: int, nf: int) -> None:
    """Raise where a mesh has more vertices or faces than the kernels over
    mesh rows index (`MAX_ROWS`; 51 GB of int64 faces at the limit)."""
    if max(nv, nf) > MAX_ROWS:
        raise ValueError(f"a mesh of {nv} vertices and {nf} faces is too large to clean on the "
                         f"card (at most {MAX_ROWS} of each)")


@dataclasses.dataclass
class Extraction:
    """Marching cubes' vertices and faces in the kernels' numbering (by
    grid point and axis) and `order`, the vertices in the host's numbering
    (order[h] is host vertex h)."""

    verts: torch.Tensor
    faces: torch.Tensor
    order: torch.Tensor


def extract(volume: torch.Tensor, level: float,
            crossing: bool = True) -> typing.Optional[Extraction]:
    """Marching cubes of a (nx, ny, nz) float64 volume (NaN: no value; a
    cell with a NaN corner emits nothing); with `crossing`, None where its
    finite values do not cross `level` (greatest > level > least), the
    engine's test."""
    if volume.dim() != 3 or volume.dtype != torch.float64:
        raise ValueError("volume must be a 3-D float64 tensor")
    cfg, ntri, lohi = classify(volume, level)
    foff = torch.cumsum(ntri, 0, dtype=torch.int64)
    emask, ecount = edges(volume, ntri, level)
    vbase = torch.cumsum(ecount, 0, dtype=torch.int64)
    nf, nv, lo, hi = torch.stack([foff[-1].double(), vbase[-1].double(), lohi[0],
                                  lohi[1]]).tolist()
    if crossing and not hi > level > lo:
        return None
    nf, nv = int(nf), int(nv)
    check_rows(nv, nf)
    verts, faces, fp = emit(volume, cfg, ntri, foff, emask, vbase, level, nv, nf)
    return Extraction(verts, faces, torch.argsort(fp))


def marching_cubes(volume: torch.Tensor, level: float = 0.0):
    """(vertices (V, 3) float32, faces (F, 3) int64) as the native
    `mc_extract` returns them, numbering included."""
    ex = extract(volume, level, crossing=False)
    rank = torch.empty_like(ex.order)
    rank[ex.order] = torch.arange(ex.order.shape[0], device=volume.device)
    return ex.verts[ex.order], rank[ex.faces]


def clean(verts: torch.Tensor, faces: torch.Tensor, min_faces: int,
          order: typing.Optional[torch.Tensor] = None):
    """`clean_simple` then `remove_small_connected_components(num_faces=
    min_faces)` of (vertices (V, 3) float32, faces (F, 3) int64), as the
    host returns them. `order` gives the vertices' host numbering (the
    merge's ties and leaders follow it; default: as they stand)."""
    nv, nf = verts.shape[0], faces.shape[0]
    check_rows(nv, nf)
    dev = verts.device
    if nv == 0:
        return verts, faces
    keys = round_keys(verts)
    perm = torch.arange(nv, device=dev) if order is None else order
    for col in (2, 1, 0):  # stable: x, then y, then z, then host order
        perm = perm[torch.sort(keys[:, col][perm], stable=True).indices]
    start = runs(keys, perm)
    gid = torch.cumsum(start, 0, dtype=torch.int32)
    inverse, leader = groups(perm, start, gid)
    if nf == 0:  # the host's merge alone
        return verts[leader[:int(gid[-1])]], faces
    two = nv >= ONE_KEY_VERTICES
    mf, k1, k2 = face_keys(faces, inverse, nv, two)
    if two:
        p = torch.sort(k2, stable=True).indices
        p = p[torch.sort(k1[p], stable=True).indices]
    else:
        p = torch.sort(k1, stable=True).indices
    alive, ekey = dedup(k1, k2, p, mf, nv)
    ekey, eidx = torch.sort(ekey)
    _, keep, used = components(ekey, eidx, mf, alive, nv, min_faces)
    fpos = torch.cumsum(keep, 0, dtype=torch.int32)
    vpos = torch.cumsum(used, 0, dtype=torch.int32)
    nf_out, nv_out, ng, n_alive = torch.stack([
        fpos[-1].long(), vpos[-1].long(), gid[-1].long(), alive.sum(dtype=torch.int64)]).tolist()
    if n_alive == 0:  # no face left: the host keeps the merged vertices
        return verts[leader[:ng]], faces[:0]
    return compact(mf, keep, fpos, vpos, verts, leader, used, ng, nf_out, nv_out)


def mesh_volume(volume: torch.Tensor, level: float, min_faces: int):
    """The engine's `mesh` phase: (vertices, faces, faces marching cubes
    emitted) of the volume's cleaned mesh, or None where the finite values
    do not cross `level`."""
    ex = extract(volume, level)
    if ex is None:
        return None
    verts, faces = clean(ex.verts, ex.faces, min_faces, order=ex.order)
    return verts, faces, ex.faces.shape[0]
