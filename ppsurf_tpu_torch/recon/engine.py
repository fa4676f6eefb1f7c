"""Reconstruction engine: region-grown volume -> marching cubes -> refine.

Host-side copy of the JAX package's engine (reference
`export_mesh_and_refine_vertices_region_growing_v3` + `_create_volume`,
`source/poco_utils.py:26-254`):

- the frontier/dilation bookkeeping stays on the host and is vectorized
  (separable boolean-shift dilation, or the native library's round walks);
- every network query goes through the `FieldEvaluator` callable;
- vertex refinement is the reference's bisection (`poco_utils.py:111-168`)
  vectorized over all crossing vertices at once, with a fixed
  `refine_iter` iteration count, optionally run by the evaluator itself;
- meshing and cleanup run where the reconstruction runs: on a CUDA device
  the volume goes to the card once and the kernels of `ops/mesh.py` mesh
  and clean it there (the same mesh, bit for bit); on the CPU the host
  route (native C++, numpy fallback) does.
"""
from __future__ import annotations

import typing

import numpy as np
import torch

from ppsurf_tpu_torch.io.ply import Mesh
from ppsurf_tpu_torch.recon.marching_cubes import marching_cubes
from ppsurf_tpu_torch.recon.mesh_ops import clean_simple, remove_small_connected_components
from ppsurf_tpu_torch.utils.spans import span

# the package's own extraction, which the card route repeats; a caller that
# puts another in `marching_cubes`' place here gets the host route
_OWN_MARCHING_CUBES = marching_cubes


def dilate_mask(mask: np.ndarray, size: int) -> np.ndarray:
    """Binary dilation by a (2*size+1)^3 cube, separable along axes."""
    out = mask
    for axis in range(3):
        acc = out.copy()
        for s in range(1, size + 1):
            shifted = np.zeros_like(out)
            src = [slice(None)] * 3
            dst = [slice(None)] * 3
            src[axis] = slice(s, None)
            dst[axis] = slice(None, -s)
            shifted[tuple(dst)] = out[tuple(src)]
            acc |= shifted
            shifted = np.zeros_like(out)
            src[axis] = slice(None, -s)
            dst[axis] = slice(s, None)
            shifted[tuple(dst)] = out[tuple(src)]
            acc |= shifted
        out = acc
    return out


def create_volume_region_growing(
    eval_field: typing.Callable[[np.ndarray], np.ndarray],
    input_points: np.ndarray,
    resolution: int,
    padding: int = 1,
    dilation_size: int = 2,
    out_value: float = 1.0,
    progress: typing.Optional[typing.Callable[[str], None]] = None,
    use_native: bool = True,
    prefill_radius: int = 0,
    prefill_period: int = 2,
    prefill_start: int = 4,
    prefill_min_band: int = 4096,
    stats: typing.Optional[typing.Dict[str, int]] = None,
) -> typing.Tuple[np.ndarray, float, float]:
    """Evaluate the field on near-surface voxels by region growing.

    Returns (volume (R+2p)^3 float64 with NaN where unevaluated, step,
    bmin_pad). Semantics follow reference `_create_volume`
    (`poco_utils.py:178-254`): seed at input-point voxels, dilate +-2,
    evaluate, grow across sign changes until the frontier is empty.

    prefill_radius > dilation_size enables the speculative prefill of
    `ppsurf_tpu/recon/engine.py:130-270`: from round `prefill_start` on,
    every `prefill_period` rounds, the voxels within +-prefill_radius of
    the next frontier that hold no value yet are evaluated in one call
    into a value cache (f32 values and a mask), and the rounds read the
    cache before they call the field. A band of fewer than
    `prefill_min_band` fresh voxels is skipped. Only the grower's rounds
    write `volume`, so the volume and the rounds are those of prefill off
    wherever the field gives a query the same value in any batch; only
    the batching of the field's calls changes. Keep prefill_radius <=
    dilation_size * prefill_period: the next `prefill_period` rounds reach
    no further.

    stats, where given, receives the rounds ("rounds"), the bands
    evaluated ("prefill_bands") and their voxels ("prefill_voxels").
    """
    bmin = float(input_points.min())
    bmax = float(input_points.max())
    step = (bmax - bmin) / (resolution - 1)
    bmin_pad = bmin - padding * step

    shape = (resolution + 2 * padding,) * 3
    volume = np.full(shape, np.nan, dtype=np.float64)

    pts_ids = ((input_points - bmin) / step).astype(np.int32) + padding
    pts_ids = np.unique(np.clip(pts_ids, 0, shape[0] - 1), axis=0)

    # per-round grid walks run in the native library when built (they cost
    # >1 s/round on a 259^3 grid in numpy); numpy fallback below
    from ppsurf_tpu_torch import native

    rg = None
    if use_native and native.available():
        rg = native.RegionGrowState(volume, dilation_size)
    unseen = None if rg is not None else np.ones(shape, dtype=bool)

    def grid_field(coords: np.ndarray) -> np.ndarray:
        return eval_field(coords.astype(np.float32) * step + bmin_pad)

    prefill = prefill_radius > dilation_size
    if prefill:
        cache_vals = np.zeros(shape, dtype=np.float32)
        cache_mask = np.zeros(shape, dtype=bool)
        pf_rg = native.RegionGrowState(volume, prefill_radius) if rg is not None else None
    counts = {} if stats is None else stats
    counts.update(rounds=0, prefill_bands=0, prefill_voxels=0)

    def eval_coords(coords: np.ndarray) -> np.ndarray:
        """The field at voxel coords, through the prefill cache when on."""
        if not prefill:
            return grid_field(coords).astype(np.float64)
        hit = cache_mask[coords[:, 0], coords[:, 1], coords[:, 2]]
        vals = np.empty(coords.shape[0], np.float64)
        vals[hit] = cache_vals[coords[hit, 0], coords[hit, 1], coords[hit, 2]]
        miss = coords[~hit]
        if miss.shape[0]:
            mv = grid_field(miss)
            vals[~hit] = mv
            cache_vals[miss[:, 0], miss[:, 1], miss[:, 2]] = mv
            cache_mask[miss[:, 0], miss[:, 1], miss[:, 2]] = True
        return vals

    def maybe_prefill(frontier_next: np.ndarray, rounds: int) -> None:
        """Evaluate the band around the next frontier into the cache (the
        voxels the coming `prefill_period` rounds can reach)."""
        if not (prefill and rounds >= prefill_start
                and (rounds - prefill_start) % prefill_period == 0
                and frontier_next.shape[0]):
            return
        if pf_rg is not None:
            band = pf_rg.dilate_unevaluated(frontier_next)
        else:
            fr = np.zeros(shape, dtype=bool)
            fr[frontier_next[:, 0], frontier_next[:, 1], frontier_next[:, 2]] = True
            reg = dilate_mask(fr, prefill_radius)
            reg &= ~np.isfinite(volume)
            band = np.argwhere(reg).astype(np.int32)
        fresh = band[~cache_mask[band[:, 0], band[:, 1], band[:, 2]]]
        if not band.shape[0] or fresh.shape[0] < prefill_min_band:
            return
        cache_vals[fresh[:, 0], fresh[:, 1], fresh[:, 2]] = grid_field(fresh)
        cache_mask[fresh[:, 0], fresh[:, 1], fresh[:, 2]] = True
        counts["prefill_bands"] += 1
        counts["prefill_voxels"] += int(fresh.shape[0])
        if progress is not None:
            progress(f"  prefill band: {fresh.shape[0]} voxels")

    rounds = 0
    if progress is not None:
        progress(f"grow seeds: {pts_ids.shape[0]} voxels")
    while pts_ids.shape[0] > 0:
        # evaluate voxels without a value yet in the +-dilation cube of the
        # frontier: the field is deterministic, so skipping re-evaluation is
        # exact (the reference recomputes, `poco_utils.py:207-232`)
        if rg is not None:
            coords = rg.dilate_unevaluated(pts_ids)
        else:
            frontier = np.zeros(shape, dtype=bool)
            frontier[pts_ids[:, 0], pts_ids[:, 1], pts_ids[:, 2]] = True
            region = dilate_mask(frontier, dilation_size)
            region &= ~np.isfinite(volume)
            coords = np.argwhere(region).astype(np.int32)
        if coords.shape[0]:
            volume[coords[:, 0], coords[:, 1], coords[:, 2]] = eval_coords(coords)
        rounds += 1
        counts["rounds"] = rounds
        if progress is not None:
            progress(f"region-grow round {rounds}: {coords.shape[0]} voxels")

        if rg is not None:
            pts_ids = rg.next_frontier(pts_ids)
            maybe_prefill(pts_ids, rounds)
            continue

        unseen[pts_ids[:, 0], pts_ids[:, 1], pts_ids[:, 2]] = False

        vals = volume[pts_ids[:, 0], pts_ids[:, 1], pts_ids[:, 2]]
        seeds_nonpos = pts_ids[vals <= 0]
        seeds_nonneg = pts_ids[vals >= 0]

        grow_from_nonpos = np.zeros(shape, dtype=bool)
        grow_from_nonpos[
            seeds_nonpos[:, 0], seeds_nonpos[:, 1], seeds_nonpos[:, 2]
        ] = True
        grow_from_nonpos = dilate_mask(grow_from_nonpos, dilation_size)

        grow_from_nonneg = np.zeros(shape, dtype=bool)
        grow_from_nonneg[
            seeds_nonneg[:, 0], seeds_nonneg[:, 1], seeds_nonneg[:, 2]
        ] = True
        grow_from_nonneg = dilate_mask(grow_from_nonneg, dilation_size)

        with np.errstate(invalid="ignore"):
            new_mask = (grow_from_nonpos & (volume >= 0) & unseen) | (
                grow_from_nonneg & (volume <= 0) & unseen
            )
        pts_ids = np.argwhere(new_mask).astype(np.int32)
        maybe_prefill(pts_ids, rounds)

    # padded borders forced to out_value (`poco_utils.py:248-253`)
    if padding > 0:
        volume[:padding], volume[-padding:] = out_value, out_value
        volume[:, :padding], volume[:, -padding:] = out_value, out_value
        volume[:, :, :padding], volume[:, :, -padding:] = out_value, out_value
    return volume, step, bmin_pad


def refine_vertices(
    verts: np.ndarray,
    volume: np.ndarray,
    eval_field: typing.Callable[[np.ndarray], np.ndarray],
    step: float,
    bmin_pad: float,
    refine_iter: int = 10,
    progress: typing.Optional[typing.Callable[[str], None]] = None,
    refine_device: typing.Optional[typing.Callable] = None,
) -> np.ndarray:
    """Bisection refinement of marching-cubes vertices along grid edges.

    verts are in grid-index space; returns world-space vertices. Follows
    reference `poco_utils.py:111-168`.
    """
    dirs = verts - np.floor(verts)
    dirs = (dirs > 0).astype(verts.dtype)
    # vertices on grid edges have exactly one fractional coordinate
    on_edge = (dirs.sum(axis=1) > 0) & (dirs.sum(axis=1) < 2)

    v = verts[on_edge]
    d = dirs[on_edge]
    v1i = np.floor(v).astype(int)
    v2i = v1i + d.astype(int)
    preds1 = volume[v1i[:, 0], v1i[:, 1], v1i[:, 2]]
    preds2 = volume[v2i[:, 0], v2i[:, 1], v2i[:, 2]]

    finite = np.isfinite(preds1) & np.isfinite(preds2)
    v = v[finite]
    v1 = v1i[finite].astype(np.float64) * step + bmin_pad
    v2 = v2i[finite].astype(np.float64) * step + bmin_pad
    preds1 = preds1[finite]
    preds2 = preds2[finite]
    mask = on_edge.copy()
    mask[on_edge] = finite

    world = verts.astype(np.float64) * step + bmin_pad
    v = v * step + bmin_pad

    if refine_device is not None:
        # all refine_iter bisection rounds inside the evaluator
        # (FieldEvaluator.refine_bisection); update rule identical to the
        # host loop below
        if progress is not None:
            progress(f"refine x{refine_iter} on device: {v.shape[0]} verts")
        world[mask] = refine_device(
            v.astype(np.float32), v1.astype(np.float32),
            v2.astype(np.float32), preds1.astype(np.float32),
            preds2.astype(np.float32), refine_iter,
        ).astype(np.float64)
        return world.astype(np.float32)

    for it in range(refine_iter):
        preds = eval_field(v.astype(np.float32)).astype(np.float64)
        if progress is not None:
            progress(f"refine iter {it}")

        m1 = (preds * preds1) > 0
        v1[m1] = v[m1]
        preds1[m1] = preds[m1]
        m2 = (preds * preds2) > 0
        v2[m2] = v[m2]
        preds2[m2] = preds[m2]
        v = 0.5 * (v1 + v2)

    world[mask] = v
    return world.astype(np.float32)


def card_device(device: typing.Union[str, torch.device, None] = None
                ) -> typing.Optional[torch.device]:
    """The card the mesh and clean phases run on: `device` where given,
    else the port's default, CUDA where a card is present
    (`device.resolve_device`'s rule); None, the host route, for the CPU."""
    dev = torch.device(device if device is not None
                       else "cuda" if torch.cuda.is_available() else "cpu")
    return dev if dev.type == "cuda" else None


def _mesh_on_card(volume: np.ndarray, level: float, min_faces: int, device: torch.device,
                  sp) -> typing.Tuple[typing.Optional[Mesh], typing.Optional[torch.Tensor]]:
    """The `mesh` phase on the card: (the cleaned mesh or None, its faces
    on the card for the `clean` phase)."""
    from ppsurf_tpu_torch.ops import mesh as card_mesh

    vol = torch.from_numpy(volume).to(device)
    sp.add(upload_bytes=volume.nbytes)
    out = card_mesh.mesh_volume(vol, level, min_faces)
    if out is None:
        return None, None
    verts, faces, emitted = out
    sp.add(faces=emitted)
    return Mesh(vertices=verts.cpu().numpy(), faces=faces.cpu().numpy()), faces


def _clean_on_card(world: np.ndarray, faces: torch.Tensor, min_faces: int, sp) -> Mesh:
    """The `clean` phase on the card: the refined vertices go up, the
    faces are still there from the `mesh` phase."""
    from ppsurf_tpu_torch.ops import mesh as card_mesh

    verts = torch.from_numpy(world).to(faces.device)
    sp.add(upload_bytes=world.nbytes)
    verts, faces = card_mesh.clean(verts, faces, min_faces)
    sp.add(faces=faces.shape[0])
    return Mesh(vertices=verts.cpu().numpy(), faces=faces.cpu().numpy())


def reconstruct_mesh(
    eval_field: typing.Callable[[np.ndarray], np.ndarray],
    input_points: np.ndarray,
    resolution: int,
    padding: int = 1,
    mc_value: float = 0.0,
    refine_iter: int = 10,
    out_value: float = 1.0,
    dilation_size: int = 2,
    min_component_faces: int = 6,
    progress: typing.Optional[typing.Callable[[str], None]] = None,
    refine_device: typing.Optional[typing.Callable] = None,
    timings: typing.Optional[typing.Dict[str, float]] = None,
    prefill_radius: int = 0,
    stats: typing.Optional[typing.Dict[str, int]] = None,
    device: typing.Union[str, torch.device, None] = None,
) -> typing.Optional[Mesh]:
    """Full reconstruction (reference
    `export_mesh_and_refine_vertices_region_growing_v3`).

    refine_device: optional evaluator-side bisection
    (FieldEvaluator.refine_bisection) — same results, no host loop.
    timings: optional dict that receives host-clock seconds per phase
    ("grow", "mesh", "refine", "clean"), the durations of the phases'
    spans (`utils/spans.py`).
    prefill_radius, stats: the grower's speculative prefill and its counts
    (`create_volume_region_growing`) — same volume, other field batches.
    device: where the reconstruction runs (`card_device`): on CUDA the mesh
    and clean phases run on the card (`ops/mesh.py`), their spans counting
    `faces` (marching cubes' faces in `mesh`, the cleaned mesh's in
    `clean`) and `upload_bytes` (copied to the card in the phase); else on
    the host, as also where `marching_cubes` was replaced. Both give the
    same mesh.
    """
    card = card_device(device) if marching_cubes is _OWN_MARCHING_CUBES else None
    with span("grow", sink=timings):
        volume, step, bmin_pad = create_volume_region_growing(
            eval_field, input_points, resolution, padding=padding,
            dilation_size=dilation_size, out_value=out_value, progress=progress,
            prefill_radius=prefill_radius, stats=stats,
        )

    with span("mesh", sink=timings) as sp:
        mesh = None  # where the field never crosses the iso level (`poco_utils.py:92-93`)
        if card is not None:
            mesh, card_faces = _mesh_on_card(volume, mc_value, min_component_faces, card, sp)
        else:
            finite = volume[np.isfinite(volume)]
            if finite.size and finite.max() > mc_value > finite.min():
                verts, faces = marching_cubes(volume, mc_value)
                mesh = clean_simple(Mesh(vertices=verts, faces=faces))
                mesh = remove_small_connected_components(mesh, num_faces=min_component_faces)
    if mesh is None or mesh.is_empty:
        return None

    with span("refine", sink=timings):
        if refine_iter > 0:
            world = refine_vertices(
                mesh.vertices.astype(np.float64), volume, eval_field, step, bmin_pad,
                refine_iter=refine_iter, progress=progress,
                refine_device=refine_device,
            )
        else:
            world = (mesh.vertices.astype(np.float64) * step + bmin_pad).astype(np.float32)

    with span("clean", sink=timings) as sp:
        if card is not None:
            return _clean_on_card(world, card_faces, min_component_faces, sp)
        mesh = clean_simple(Mesh(vertices=world, faces=mesh.faces))
        mesh = remove_small_connected_components(mesh, num_faces=min_component_faces)
    return mesh
