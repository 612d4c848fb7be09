"""Lightcurve augmentation as masked transforms over packed tensors (port
of ``mallorn_tpu.data.augmentation``).

- flux scaling, time stretch, time shift, Gaussian noise, observation
  dropout, S/N degradation, redshift augmentation (time dilation and
  d_L^2 flux scaling), TDE mixup and dataset expansion;
- every transform works on both views (band and all-band) of the port's
  ``PackedLightcurves``, on the tensors' device, over the object axis at
  once.

Keys are ``utils.prng`` keys ([2] uint32, the JAX package's
``jax.random`` keys); every draw is made on the host by ``utils.prng``,
as ``jax.random`` makes it, and moved to the data's device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from mallorn_tpu_torch.data.packing import Metadata, PackedLightcurves
from mallorn_tpu_torch.utils import prng


def _dev(x: np.ndarray, packed: PackedLightcurves) -> torch.Tensor:
    return torch.as_tensor(x).to(packed.device)


def _map_views(packed: PackedLightcurves, fn) -> PackedLightcurves:
    """Apply ``fn(t, f, e, mask, per_object_shape) -> (t, f, e)`` to both
    views; ``per_object_shape`` reshapes an [N] vector against the view."""
    n = packed.n_objects
    bt, bf, be = fn(packed.band_time, packed.band_flux, packed.band_err,
                    packed.band_mask, (n, 1, 1), 0)
    at, af, ae = fn(packed.all_time, packed.all_flux, packed.all_err,
                    packed.all_mask, (n, 1), 1)
    return packed._replace(band_time=bt, band_flux=bf, band_err=be,
                           all_time=at, all_flux=af, all_err=ae)


def _stretch(t, m, s):
    """Times stretched by ``s`` about each row's first valid time."""
    t0 = torch.where(m, t, torch.inf).amin(dim=-1, keepdim=True)
    t0 = torch.where(torch.isfinite(t0), t0, 0.0)
    return torch.where(m, t0 + (t - t0) * s, t)


def flux_scale(packed: PackedLightcurves, key, lo: float = 0.8,
               hi: float = 1.2) -> PackedLightcurves:
    """Per-object multiplicative flux scaling."""
    s = _dev(prng.uniform(key, (packed.n_objects,), lo, hi), packed)
    return _map_views(packed, lambda t, f, e, m, shp, _: (
        t, f * s.reshape(shp), e * s.reshape(shp)))


def time_stretch(packed: PackedLightcurves, key, lo: float = 0.9,
                 hi: float = 1.1) -> PackedLightcurves:
    """Per-object time stretch about the first observation."""
    s = _dev(prng.uniform(key, (packed.n_objects,), lo, hi), packed)
    return _map_views(packed, lambda t, f, e, m, shp, _: (
        _stretch(t, m, s.reshape(shp)), f, e))


def time_shift(packed: PackedLightcurves, key, max_shift: float = 20.0
               ) -> PackedLightcurves:
    """A uniform shift in [-max_shift, max_shift) days per object."""
    d = _dev(prng.uniform(key, (packed.n_objects,), -max_shift, max_shift), packed)
    return _map_views(packed, lambda t, f, e, m, shp, _: (
        torch.where(m, t + d.reshape(shp), t), f, e))


def noise_injection(packed: PackedLightcurves, key, scale: float = 0.5
                    ) -> PackedLightcurves:
    """Gaussian noise of ``scale`` x flux_err on every valid point."""
    keys = prng.split(key)

    def fn(t, f, e, m, shp, view):
        n = _dev(prng.normal(keys[view], tuple(f.shape)), packed) * e * scale
        return t, torch.where(m, f + n, f), e

    return _map_views(packed, fn)


def _drop(mask: torch.Tensor, u: torch.Tensor, frac: float, min_keep: int):
    keep = mask & (u > frac)
    # keep at least min_keep per row: the valid points of smallest u
    rank = ((u[..., None, :] < u[..., :, None]) & mask[..., None, :]).sum(dim=-1)
    return keep | (mask & (rank < min_keep))


def observation_dropout(packed: PackedLightcurves, key, frac: float = 0.2,
                        min_keep: int = 5) -> PackedLightcurves:
    """Mask out ``frac`` of the observations, keeping at least ``min_keep``
    per row; values stay in place (the mask-aware features ignore them)."""
    k1, k2 = prng.split(key)
    ub = _dev(prng.uniform(k1, tuple(packed.band_mask.shape)), packed)
    ua = _dev(prng.uniform(k2, tuple(packed.all_mask.shape)), packed)
    return packed._replace(band_mask=_drop(packed.band_mask, ub, frac, min_keep),
                           all_mask=_drop(packed.all_mask, ua, frac, min_keep))


def snr_degradation(packed: PackedLightcurves, key, factor_lo: float = 1.2,
                    factor_hi: float = 2.0) -> PackedLightcurves:
    """Inflate the errors by a per-object factor and add the matching
    noise."""
    k0, k1, k2 = prng.split(key, 3)
    fac = _dev(prng.uniform(k0, (packed.n_objects,), factor_lo, factor_hi), packed)
    noise_keys = (k1, k2)

    def fn(t, f, e, m, shp, view):
        e2 = e * fac.reshape(shp)
        extra = torch.sqrt(torch.clamp(e2 ** 2 - e ** 2, min=0.0))
        n = _dev(prng.normal(noise_keys[view], tuple(f.shape)), packed) * extra
        return t, torch.where(m, f + n, f), torch.where(m, e2, e)

    return _map_views(packed, fn)


def _lum_dist_low_z(z):
    return (299792.458 / 70.0) * z * (1.0 + z / 2.0)


def redshift_augment(packed: PackedLightcurves, meta: Metadata, key,
                     dz_lo: float = -0.05, dz_hi: float = 0.1
                     ) -> Tuple[PackedLightcurves, Metadata]:
    """Move objects in redshift: times dilated by (1 + z') / (1 + z) about
    the first observation, fluxes and errors scaled by (d_L(z) / d_L(z'))^2."""
    z_host = np.asarray(meta.z, np.float32)
    dz = prng.uniform(key, z_host.shape, dz_lo, dz_hi)
    z_new = np.clip(z_host + dz, np.float32(0.01), np.float32(3.0)).astype(np.float32)
    z, zn = _dev(z_host, packed), _dev(z_new, packed)
    dil = (1.0 + zn) / (1.0 + z)
    fscale = (_lum_dist_low_z(z) / _lum_dist_low_z(zn)) ** 2

    def fn(t, f, e, m, shp, _):
        return (_stretch(t, m, dil.reshape(shp)), f * fscale.reshape(shp),
                e * fscale.reshape(shp))

    new_meta = Metadata(object_ids=meta.object_ids, z=z_new, ebv=meta.ebv,
                        target=meta.target, spec_type=meta.spec_type)
    return _map_views(packed, fn), new_meta


def tde_mixup(packed: PackedLightcurves, meta: Metadata, key,
              alpha: float = 0.3) -> PackedLightcurves:
    """Blend every TDE's fluxes with a partner TDE's: l x + (1 - l) x_p,
    l ~ Beta(alpha, alpha), partners from a permutation of the TDE rows."""
    y = np.asarray(meta.target)
    n = packed.n_objects
    is_tde = y == 1
    tde_idx = np.zeros(len(y), np.int64)
    nz = np.flatnonzero(is_tde)
    tde_idx[:len(nz)] = nz
    k1, k2 = prng.split(key)
    perm = tde_idx[prng.permutation(k1, len(y))]
    partner = _dev(perm[np.arange(n) % max(len(nz), 1)], packed)
    lam = _dev(prng.beta(k2, alpha, alpha, (n,)), packed)
    tde = _dev(is_tde, packed)

    def mix(x):
        shp = (-1,) + (1,) * (x.dim() - 1)
        l = lam.reshape(shp)
        return torch.where(tde.reshape(shp), l * x + (1 - l) * x[partner], x)

    return packed._replace(band_flux=mix(packed.band_flux),
                           all_flux=mix(packed.all_flux))


def augment_dataset(packed: PackedLightcurves, meta: Metadata, key,
                    n_copies: int = 1) -> Tuple[PackedLightcurves, Metadata]:
    """The originals followed by ``n_copies`` transformed copies (flux
    scale, time stretch, noise, dropout), ids suffixed ``_aug{c}``."""
    parts, metas = [packed], [meta]
    for c in range(n_copies):
        key, k1, k2, k3, k4 = prng.split(key, 5)
        aug = flux_scale(packed, k1)
        aug = time_stretch(aug, k2)
        aug = noise_injection(aug, k3)
        aug = observation_dropout(aug, k4)
        parts.append(aug)
        metas.append(Metadata(
            object_ids=np.array([f"{o}_aug{c}" for o in meta.object_ids]),
            z=meta.z, ebv=meta.ebv, target=meta.target, spec_type=meta.spec_type))
    out = PackedLightcurves(
        *[torch.cat([getattr(p, fld) for p in parts], dim=0)
          for fld in PackedLightcurves._fields[:-1]],
        time_offset=packed.time_offset)
    mo = Metadata(
        object_ids=np.concatenate([m.object_ids for m in metas]),
        z=np.concatenate([m.z for m in metas]),
        ebv=np.concatenate([m.ebv for m in metas]),
        target=(np.concatenate([m.target for m in metas])
                if meta.target is not None else None),
        spec_type=None)
    return out, mo
