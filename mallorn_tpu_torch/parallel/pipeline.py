"""The v92d pipeline on a mesh (port of ``mallorn_tpu.parallel.pipeline``).

- Feature extraction splits the objects over the ranks: every family is a
  per-object computation, so each rank extracts its block of objects
  (shard-local, no communication) and each family is gathered once at the
  end. The 2D GP's compacted width and its two-phase gate come from the
  global valid counts (``multiband_gp.gp_schedule``), as the JAX package
  decides them globally, so an object's features never depend on which
  rank fitted it.
- GBDT training splits every fold's rows over the ranks
  (``parallel.sharded_train``), exactly the single-device trees.

``run_v92d_pipeline_sharded`` is the whole winning pipeline: sharded
extraction of both splits, the selection CV, the v34a assembly, the
adversarial weights and the v92 CV, every CV on the mesh.
"""

from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves, unify_time_padding
from mallorn_tpu_torch.features import bazin, multiband_gp, tde
from mallorn_tpu_torch.features.base import FeatureSet, chunked_extract, feature_matrix
from mallorn_tpu_torch.parallel.mesh import Mesh

FAMILIES = ("features_v4", "tde_physics", "multiband_gp", "bazin")


def _rank_objects(mesh: Mesh, idx: np.ndarray, rank: int) -> np.ndarray:
    """Rank ``rank``'s block of the objects ``idx`` (a chunk), padded to the
    mesh's quantum with -1."""
    b = -(-len(idx) // mesh.size)
    blk = idx[rank * b:(rank + 1) * b]
    return np.concatenate([blk, np.full(b - len(blk), -1, np.int64)])


def extract_v34a_bundle_sharded(mesh: Mesh, packed: PackedLightcurves, meta: Metadata,
                                gp_steps: int = 100,
                                chunk_size: Optional[int] = None) -> Dict[str, FeatureSet]:
    """The four v34a families of ``packed`` (``pipelines.extract_v34a_bundle``'s
    outputs) with the objects split over the mesh, on the mesh's device.

    ``chunk_size``: objects are taken in valid-count-sorted chunks of at
    most that many (as the single-device GP's chunks), each chunk's GP at
    its own compacted width, each chunk split over the ranks; None = one
    chunk at the global width. Every rank returns the whole bundle."""
    from mallorn_tpu_torch.train.pipelines import extract_features_v4

    dev = mesh.device
    n = packed.n_objects
    counts = multiband_gp._use_mask(packed).sum(dim=1).cpu().numpy()
    cs = chunk_size or max(n, 1)
    two_phase, widths = multiband_gp.gp_schedule(counts, packed.all_time.shape[1], gp_steps,
                                                 cs)
    order = np.argsort(counts, kind="stable") if n > cs else np.arange(n)
    chunks = [order[s:s + cs].astype(np.int64) for s in range(0, n, cs)]

    parts: Dict[str, list] = {f: [] for f in FAMILIES}
    names: Dict[str, list] = {}
    for idx, tc in zip(chunks, widths):
        blk = _rank_objects(mesh, idx, mesh.rank)
        take = np.where(blk >= 0, blk, idx[0])  # a padded slot repeats an object
        ti = torch.as_tensor(take)
        sub = packed.map(lambda x: x[ti.to(x.device)].to(dev))
        sub_meta = Metadata(object_ids=None, z=np.asarray(meta.z)[take],
                            ebv=np.asarray(meta.ebv)[take])
        fams = {"features_v4": extract_features_v4(sub, sub_meta),
                "tde_physics": chunked_extract(tde.extract, sub),
                "multiband_gp": multiband_gp._extract_chunk(sub, gp_steps, tc, two_phase),
                "bazin": chunked_extract(bazin.extract, sub)}
        for fam, fs in fams.items():
            X, names[fam] = feature_matrix(fs)
            parts[fam].append(X)

    # every rank's object positions, in the order of the gathered rows
    pos = torch.as_tensor(np.concatenate([
        np.concatenate([_rank_objects(mesh, idx, r) for idx in chunks])
        for r in range(mesh.size)]), device=dev)
    keep = pos >= 0
    out = {}
    for fam in FAMILIES:
        rows = mesh.all_gather(torch.cat(parts[fam]))  # one gather per family
        X = torch.empty(n, rows.shape[1], dtype=rows.dtype, device=dev)
        X[pos[keep]] = rows[keep]
        out[fam] = {k: X[:, i] for i, k in enumerate(names[fam])}
    return out


def run_v92d_pipeline_sharded(mesh: Mesh, train_packed: PackedLightcurves,
                              train_meta: Metadata, test_packed: PackedLightcurves,
                              test_meta: Metadata, params=None, selection_params=None,
                              gp_steps: int = 100, top_k: int = 120, adv_params=None,
                              variants: Optional[Dict] = None,
                              chunk_size: Optional[int] = None, selection_cache=None,
                              verbose: bool = False):
    """The winning pipeline on a mesh: sharded extraction of both splits ->
    the selection CV -> the v34a assembly -> adversarial validation -> the
    v92 CV (``variants``, default v92d), every GBDT fold's rows split over
    the ranks. ``selection_cache``: the staged selection artifact (rank 0
    writes it). Returns (V92Result, timings)."""
    from mallorn_tpu_torch.train import pipelines
    from mallorn_tpu_torch.train.cv import train_cv
    from mallorn_tpu_torch.train.feature_selection import cached_select_features

    params = params or pipelines.V34A_PARAMS
    sel_params = selection_params or params
    timings = {}
    t0 = time.perf_counter()
    train_packed, test_packed = unify_time_padding(train_packed, test_packed)
    tr_bundle = extract_v34a_bundle_sharded(mesh, train_packed, train_meta, gp_steps,
                                            chunk_size)
    te_bundle = extract_v34a_bundle_sharded(mesh, test_packed, test_meta, gp_steps,
                                            chunk_size)
    timings["features_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    y = np.asarray(train_meta.target)
    Xv4, v4_names = feature_matrix(tr_bundle["features_v4"])
    Xv4 = pipelines.finite_or_nan(Xv4).cpu().numpy()
    selection = cached_select_features(
        selection_cache, Xv4, y, v4_names,
        lambda: train_cv(Xv4, y, None, sel_params, mesh=mesh).importance_gain, top_k,
        key_extra=pipelines.params_digest(sel_params), save=mesh.rank == 0)
    X_tr, names = pipelines.assemble_v34a_matrix(tr_bundle, selection.selected)
    X_te, _ = pipelines.assemble_v34a_matrix(te_bundle, selection.selected)
    timings["selection_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    out = pipelines.run_v92(X_tr.cpu().numpy(), y, names, X_te.cpu().numpy(), params=params,
                            variants=variants or pipelines.V92D_ONLY, adv_params=adv_params,
                            mesh=mesh, verbose=verbose)
    timings["train_s"] = time.perf_counter() - t0
    return out, timings
