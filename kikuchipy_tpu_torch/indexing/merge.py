"""Merge single-phase crystal maps into a multi-phase map (host NumPy, as
``kikuchipy_tpu/indexing/merge.py``).

kikuchipy's ``merge_crystal_maps`` semantics
(``indexing/_merge_crystal_maps.py``): the phase at each point is the one
whose mean of the ``mean_n_best`` best scores wins; per-point
rotations/scores/simulation indices are taken from the winning map, and
combined sorted score/index arrays are added as ``merged_*`` properties
(indices offset per map so they stay unique for OSM computation).
"""

from __future__ import annotations

import numpy as np

from kikuchipy_tpu_torch.crystallography.crystal_map import CrystalMap, PhaseList

__all__ = ["merge_crystal_maps"]


def merge_crystal_maps(
    crystal_maps: list[CrystalMap],
    mean_n_best: int = 1,
    greater_is_better: bool | None = None,
    scores_prop: str = "scores",
    simulation_indices_prop: str | None = "simulation_indices",
    navigation_masks: list[np.ndarray | None] | None = None,
) -> CrystalMap:
    """Merge per-phase crystal maps by comparing scores per point.

    Parameters
    ----------
    crystal_maps
        At least two maps with ``scores_prop`` among their properties.
    mean_n_best
        Number of best scores averaged before comparing. A negative
        value with ``greater_is_better`` unset means lower-is-better
        (reference ``_merge_crystal_maps.py:52-54,171-177``).
    greater_is_better
        True if a higher score is a better match; default inferred from
        the sign of ``mean_n_best``.
    navigation_masks
        One boolean mask per map over the full navigation grid, with
        False marking the points the map covers (reference
        ``:68-76``); lets maps indexed on disjoint/partial subsets (e.g.
        per-phase ``navigation_mask`` dictionary indexing) merge onto
        the full grid. ``None`` entries mean the map covers every
        point. Points covered by no map get ``phase_id`` -1 and NaN
        scores.
    """
    n_maps = len(crystal_maps)
    if n_maps < 2:
        raise ValueError("Pass at least two crystal maps to merge")

    if greater_is_better is None:
        sign = 1.0 if mean_n_best >= 0 else -1.0
        mean_n_best = abs(mean_n_best)
    else:
        sign = 1.0 if greater_is_better else -1.0

    rpp = {xmap.rotations_per_point for xmap in crystal_maps}
    if len(rpp) != 1:
        raise ValueError(
            "Crystal maps must have the same number of rotations per point"
        )
    n_per_point = rpp.pop()

    if navigation_masks is not None:
        if len(navigation_masks) != n_maps:
            raise ValueError(
                "Number of crystal maps and navigation masks must be equal"
            )
        map_shapes = []
        keeps = []
        for i, (mask, xmap) in enumerate(zip(navigation_masks, crystal_maps)):
            if mask is None:
                map_shapes.append(xmap.shape)
                keeps.append(None)
            else:
                mask = np.asarray(mask, dtype=bool)
                if int((~mask).sum()) != xmap.size:
                    raise ValueError(
                        f"{i}. navigation mask does not have as many 'False' "
                        f"entries, {int((~mask).sum())}, as there are points "
                        f"in the crystal map, {xmap.size}"
                    )
                map_shapes.append(mask.shape)
                keeps.append(np.nonzero(~mask.ravel())[0])
        if len({tuple(s) for s in map_shapes}) != 1:
            raise ValueError(
                "Crystal maps (and/or navigation masks) must have the same "
                f"navigation shape; got {map_shapes}"
            )
        map_shape = tuple(map_shapes[0])
    else:
        shapes = {xmap.shape for xmap in crystal_maps}
        if len(shapes) != 1:
            raise ValueError(
                f"Crystal maps must have the same navigation shape; got {shapes}"
            )
        map_shape = tuple(shapes.pop())
        keeps = [None] * n_maps
    m = int(np.prod(map_shape))

    def _expand(values: np.ndarray, keep, fill) -> np.ndarray:
        """Scatter a per-map-point array onto the full grid."""
        values = np.asarray(values)
        if keep is None:
            return values.reshape((m,) + values.shape[1:])
        out = np.full((m,) + values.shape[1:], fill, dtype=np.result_type(values, type(fill)))
        out[keep] = values
        return out

    # (M, N, K) combined scores; uncovered points are NaN, and so are a
    # map's own not-indexed points (phase_id -1) — they never compete
    # (reference ``_merge_crystal_maps.py`` not-indexed handling).
    def _map_scores(x, keep):
        sc = np.asarray(x.prop[scores_prop], dtype=float).reshape(x.size, -1)
        not_indexed = np.asarray(x.phase_id) < 0
        if not_indexed.any():
            sc = sc.copy()
            sc[not_indexed] = np.nan
        return _expand(sc, keep, np.nan)

    combined = np.stack(
        [_map_scores(x, keep) for x, keep in zip(crystal_maps, keeps)],
        axis=-1,
    )

    # Mean of the n best scores per (point, map). All-NaN columns
    # (uncovered points) are computed via a masked sum rather than
    # np.nanmean, which would emit a "Mean of empty slice"
    # RuntimeWarning for them; their result stays NaN by construction.
    window = combined[:, :mean_n_best]  # (M, n, K)
    valid = ~np.isnan(window)
    n_valid = valid.sum(axis=1)  # (M, K)
    summed = np.where(valid, window, 0.0).sum(axis=1)
    best = np.divide(
        summed,
        n_valid,
        out=np.full(summed.shape, np.nan, dtype=summed.dtype),
        where=n_valid > 0,
    )  # (M, K)
    covered = ~np.isnan(best).all(axis=1)
    phase_id = np.full(m, -1, dtype=np.int64)
    if covered.any():
        masked = np.where(np.isnan(best), -np.inf, sign * best)
        phase_id[covered] = np.argmax(masked[covered], axis=1)

    rot_shape = (m, n_per_point, 4) if n_per_point > 1 else (m, 4)
    new_rot = np.zeros(rot_shape)
    new_rot[..., 0] = 1.0  # identity at uncovered points
    new_scores = np.full(combined.shape[:-1], np.nan, dtype=combined.dtype)
    new_idx = (
        np.full(combined.shape[:-1], -1, dtype=np.int64)
        if simulation_indices_prop is not None
        else None
    )

    phases = PhaseList()
    for i, (xmap, keep) in enumerate(zip(crystal_maps, keeps)):
        mask = phase_id == i
        phase = xmap.phases[xmap.phases.ids[0]] if len(xmap.phases) else None
        if phase is not None:
            if phase.name in phases.names:
                existing_id = phases.ids[phases.names.index(phase.name)]
                existing = phases[existing_id]
                if existing.space_group == phase.space_group:
                    # Identical phases are considered as one phase
                    # (reference merge_crystal_maps docstring).
                    phase_id[mask] = existing_id
                else:
                    # Same name, different phase: rename with a numeric
                    # suffix and warn (reference
                    # ``_merge_crystal_maps.py`` duplicate handling).
                    import dataclasses as _dc
                    import warnings

                    n_dupes = sum(
                        1
                        for nm in phases.names
                        if nm == phase.name or (
                            nm.startswith(phase.name)
                            and nm[len(phase.name):].isdigit()
                        )
                    )
                    new_name = f"{phase.name}{n_dupes}"
                    warnings.warn(
                        f"There are duplicates of phase '{phase.name}', "
                        f"renaming this one to '{new_name}'",
                        UserWarning,
                    )
                    phases.add(i, _dc.replace(phase, name=new_name))
            else:
                phases.add(i, phase)
        if not mask.any():
            continue
        new_rot[mask] = _expand(
            np.asarray(xmap.rotations).reshape((xmap.size,) + rot_shape[1:]),
            keep,
            0.0,
        )[mask]
        new_scores[mask] = _expand(
            np.asarray(xmap.prop[scores_prop]).reshape(xmap.size, -1),
            keep,
            np.nan,
        )[mask]
        if new_idx is not None and simulation_indices_prop in xmap.prop:
            new_idx[mask] = _expand(
                np.asarray(xmap.prop[simulation_indices_prop]).reshape(
                    xmap.size, -1
                ),
                keep,
                -1,
            )[mask]

    # Merged, sorted scores across all maps (NaN sort last either way).
    flat = combined.reshape(m, -1)
    order = np.argsort(sign * -flat, kind="mergesort", axis=1)
    merged_scores = np.take_along_axis(flat, order, axis=1)
    props = {scores_prop: new_scores, f"merged_{scores_prop}": merged_scores}

    if simulation_indices_prop is not None:
        sim_list = []
        offset = 0
        for i, (xmap, keep) in enumerate(zip(crystal_maps, keeps)):
            sim = _expand(
                np.asarray(xmap.prop[simulation_indices_prop]).reshape(
                    xmap.size, -1
                ),
                keep,
                -1,
            ).astype(np.float64)
            sim[sim < 0] = np.nan
            if i > 0:
                prev = sim_list[-1]
                offset = (
                    int(np.nanmax(prev)) + 1 if not np.isnan(prev).all() else offset
                )
            sim_list.append(sim + offset)
        comb_sim = np.stack(sim_list, axis=-1).reshape(m, -1)
        merged_sim = np.take_along_axis(comb_sim, order, axis=1)
        props[simulation_indices_prop] = new_idx
        props[f"merged_{simulation_indices_prop}"] = merged_sim

    first = crystal_maps[0]
    return CrystalMap(
        rotations=new_rot,
        phase_id=phase_id,
        shape=map_shape,
        prop=props,
        phases=phases,
        scan_unit=first.scan_unit,
    )
