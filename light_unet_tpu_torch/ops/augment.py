"""On-device patch augmentation (port of ``light_unet_tpu/ops/augment.py``).

Random flip (p 0.5, axis from the config), random rotation +-15 deg in a
random axis pair (p 0.5; image order 1, label order 0), random scale
0.9-1.1 (p 0.3), intensity shift +-0.1 with clip [0,1] (p 0.5), Gaussian
noise sigma 0.01 with clip (p 0.3).  Rotation and scale are one affine
resample about the patch center.  Two forms of it, as in the JAX package:
``affine_resample`` (8 trilinear taps gathered in 3-D, ``map_coordinates``
semantics) and ``affine_resample_separable`` (the affine is block-diagonal:
a 2-tap linear interpolation along the untouched axis, then a 4-tap
bilinear in the rotation plane).

The draws come from an explicit ``torch.Generator`` on the batch's device.
A rank of a data-parallel mesh holds some rows of the global batch
(``rows``): it draws for the whole global batch and keeps its rows, so that
every rank stays on the generator's one stream and N ranks augment as one
process does.
Choices that differ per sample (flip axis, rotation plane) are made
branch-free: every branch is computed and ``torch.where`` selects, so a
step never waits for the host.  Inactive transforms (angle 0, scale 1)
sample at integer coordinates and are exact identities.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch


def _round_half_away(x: torch.Tensor) -> torch.Tensor:
    """``lax.round``: halves away from zero (``torch.round`` takes them to even)."""
    t = torch.trunc(x)
    return torch.where((x - t).abs() == 0.5, t + torch.sign(x), torch.round(x))


def _plane_rotation(angle: torch.Tensor, pair_idx: torch.Tensor, pairs) -> torch.Tensor:
    """[B, 3, 3] rotation matrices by ``angle`` in the plane ``pairs[pair_idx]``."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    rots = []
    for a, b in pairs:
        m = torch.eye(3, device=angle.device).repeat(angle.shape[0], 1, 1)
        m[:, a, a] = cos
        m[:, a, b] = -sin
        m[:, b, a] = sin
        m[:, b, b] = cos
        rots.append(m)
    rots = torch.stack(rots, 1)  # [B, n_pairs, 3, 3]
    return rots[torch.arange(angle.shape[0], device=angle.device), pair_idx.long()]


def affine_resample(image: torch.Tensor, label: torch.Tensor, angle, pair_idx, scale,
                    pairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """Rotate ``image``/``label`` [B, D, H, W] by ``angle`` [B] (radians) in the
    plane ``pairs[pair_idx]`` and scale by ``scale`` [B] about the center, in
    one trilinear (image) / nearest (label) resample with zero fill."""
    bsz, *shape = image.shape
    dev = image.device
    center = [(s - 1) / 2.0 for s in shape]
    rot = _plane_rotation(angle, pair_idx, pairs)
    grid = torch.meshgrid(*[torch.arange(s, dtype=torch.float32, device=dev) for s in shape],
                          indexing="ij")
    rel = [g - c for g, c in zip(grid, center)]
    # inverse map: output voxel -> input coordinate (rotate back, unscale)
    src = []
    for i in range(3):
        acc = rot[:, 0, i, None, None, None] * rel[0]
        acc = acc + rot[:, 1, i, None, None, None] * rel[1]
        acc = acc + rot[:, 2, i, None, None, None] * rel[2]
        src.append(acc / scale[:, None, None, None] + center[i])
    bidx = torch.arange(bsz, device=dev)[:, None, None, None]

    def tap(vol, idx):
        valid = torch.ones_like(idx[0], dtype=torch.bool)
        for i, s in zip(idx, shape):
            valid = valid & (i >= 0) & (i < s)
        clamped = [torch.clamp(i, 0, s - 1) for i, s in zip(idx, shape)]
        return torch.where(valid, vol[bidx, clamped[0], clamped[1], clamped[2]],
                           torch.zeros((), dtype=vol.dtype, device=dev))

    nodes = []
    for c in src:
        lower = torch.floor(c)
        upper_w = c - lower
        nodes.append(((lower.long(), 1 - upper_w), (lower.long() + 1, upper_w)))
    img_out = None
    for (i0, w0) in nodes[0]:
        for (i1, w1) in nodes[1]:
            for (i2, w2) in nodes[2]:
                term = (w0 * w1 * w2) * tap(image, (i0, i1, i2))
                img_out = term if img_out is None else img_out + term
    lbl_out = tap(label, [_round_half_away(c).long() for c in src])
    return img_out, lbl_out


def _linear_taps_1d(n: int, scale: torch.Tensor):
    """Trilinear taps along one axis of length ``n`` for scaling about its
    center: per sample and output k, (floor index, weight 1-t, weight t) of
    source ``(k - c)/scale + c``; taps outside [0, n-1] weigh nothing."""
    c = (n - 1) / 2.0
    k = torch.arange(n, dtype=torch.float32, device=scale.device)
    src = (k - c) / scale[:, None] + c
    f = torch.floor(src)
    t = src - f
    return f, 1.0 - t, t


def _separable_branch(image, label, cos, sin, scale, pair):
    """One rotation plane of ``affine_resample_separable`` for the whole batch."""
    a, b = pair
    c = ({0, 1, 2} - {a, b}).pop()
    perm = (0, 1 + a, 1 + b, 1 + c)
    inv = tuple(perm.index(i) for i in range(4))
    img = image.permute(perm)
    lab = label.permute(perm)
    bsz, na_, nb_, nc_ = img.shape
    dev = img.device
    zero = torch.zeros((), dtype=img.dtype, device=dev)

    # untouched axis: 2-tap linear interpolation / nearest take
    f, w_lo, w_hi = _linear_taps_1d(nc_, scale)
    out = None
    for off, w in ((0.0, w_lo), (1.0, w_hi)):
        j = f + off
        ok = (j >= 0) & (j <= nc_ - 1)
        vals = torch.gather(img, 3, torch.clamp(j, 0, nc_ - 1).long()[:, None, None, :]
                            .expand(bsz, na_, nb_, nc_))
        term = torch.where(ok[:, None, None, :], vals * w[:, None, None, :], zero)
        out = term if out is None else out + term
    img = out
    cc = (nc_ - 1) / 2.0
    src_c = (torch.arange(nc_, dtype=torch.float32, device=dev) - cc) / scale[:, None] + cc
    idx_c = torch.round(src_c)
    ok_c = ((idx_c >= 0) & (idx_c <= nc_ - 1)).to(lab.dtype)
    lab = torch.gather(lab, 3, torch.clamp(idx_c, 0, nc_ - 1).long()[:, None, None, :]
                       .expand(bsz, na_, nb_, nc_))
    lab = lab * ok_c[:, None, None, :]

    # rotation plane: 4-tap bilinear row gathers shared across the minor axis
    ca, cb = (na_ - 1) / 2.0, (nb_ - 1) / 2.0
    rel_a = torch.arange(na_, dtype=torch.float32, device=dev)[:, None] - ca
    rel_b = torch.arange(nb_, dtype=torch.float32, device=dev)[None, :] - cb
    cs, sn, sc = cos[:, None, None], sin[:, None, None], scale[:, None, None]
    src_a = (cs * rel_a + sn * rel_b) / sc + ca   # [B, A, Bd]
    src_b = (-sn * rel_a + cs * rel_b) / sc + cb
    fa, fb = torch.floor(src_a), torch.floor(src_b)
    ta, tb = src_a - fa, src_b - fb
    flat = img.reshape(bsz, na_ * nb_, nc_)

    def rows(table, ia, ib):
        ridx = (torch.clamp(ia, 0, na_ - 1) * nb_ + torch.clamp(ib, 0, nb_ - 1)).long()
        return torch.gather(table, 1, ridx.reshape(bsz, -1, 1).expand(bsz, na_ * nb_, nc_)) \
            .reshape(bsz, na_, nb_, nc_)

    acc = torch.zeros_like(img)
    for da, wa in ((0.0, 1.0 - ta), (1.0, ta)):
        for db, wb in ((0.0, 1.0 - tb), (1.0, tb)):
            ra, rb = fa + da, fb + db
            ok = (ra >= 0) & (ra <= na_ - 1) & (rb >= 0) & (rb <= nb_ - 1)
            acc = acc + (wa * wb * ok)[..., None] * rows(flat, ra, rb)
    ia, ib = torch.round(src_a), torch.round(src_b)
    ok = (ia >= 0) & (ia <= na_ - 1) & (ib >= 0) & (ib <= nb_ - 1)
    lab_out = rows(lab.reshape(bsz, na_ * nb_, nc_), ia, ib) * ok[..., None].to(lab.dtype)
    return acc.permute(inv), lab_out.permute(inv)


def affine_resample_separable(image: torch.Tensor, label: torch.Tensor, angle, pair_idx, scale,
                              pairs) -> Tuple[torch.Tensor, torch.Tensor]:
    """``affine_resample`` factorized along the block-diagonal affine: the
    same taps and weights, fewer and more regular gathers.  Every plane of
    ``pairs`` is computed and each sample keeps its own (``pair_idx``)."""
    cos, sin = torch.cos(angle), torch.sin(angle)
    pair_idx = pair_idx.long()
    img_out = lbl_out = None
    for p, pair in enumerate(pairs):
        img_p, lbl_p = _separable_branch(image, label, cos, sin, scale, pair)
        pick = (pair_idx == p)[:, None, None, None]
        img_out = img_p if img_out is None else torch.where(pick, img_p, img_out)
        lbl_out = lbl_p if lbl_out is None else torch.where(pick, lbl_p, lbl_out)
    return img_out, lbl_out


def make_augment_fn(aug_cfg, patch_size: Sequence[int], separable: bool = False) -> Callable:
    """Build ``fn(generator, images[B,D,H,W,1], labels, rows=None) -> (images,
    labels)`` from an ``AugmentationConfig``.  Ten uniforms per sample are
    drawn every call (plus the noise field when noise is on), whatever is
    enabled; with ``rows=(lo, hi, total)`` the batch is rows ``lo:hi`` of a
    global batch of ``total`` and the draws are the global batch's."""
    flip = aug_cfg.random_flip
    rot = aug_cfg.random_rotation
    scale_cfg = aug_cfg.random_scale
    shift_cfg = aug_cfg.intensity_shift
    noise_cfg = aug_cfg.gaussian_noise

    flip_axes = tuple(flip.get("axes", [0, 1, 2]))
    rot_pairs = tuple(tuple(p) for p in rot.get("axes", [[0, 1], [0, 2], [1, 2]]))
    angle_lo, angle_hi = rot.get("angle_range", [-15, 15])
    scale_lo, scale_hi = scale_cfg.get("scale_range", [0.9, 1.1])
    shift_lo, shift_hi = shift_cfg.get("shift_range", [-0.1, 0.1])
    sigma = noise_cfg.get("sigma", 0.01)
    resample = affine_resample_separable if separable else affine_resample

    def pick(u, n):
        return torch.clamp((u * n).long(), max=n - 1)

    def augment_batch(gen: torch.Generator, images: torch.Tensor, labels: torch.Tensor,
                      rows=None):
        image, label = images[..., 0], labels[..., 0]
        bsz = image.shape[0]
        lo, hi, total = rows if rows is not None else (0, bsz, bsz)
        u = torch.rand((total, 10), generator=gen, device=image.device)[lo:hi]
        bshape = (bsz, 1, 1, 1)

        if flip.get("enabled", False):
            do = u[:, 0] < flip.get("prob", 0.5)
            which = pick(u[:, 1], len(flip_axes))
            for i, ax in enumerate(flip_axes):
                sel = (do & (which == i)).reshape(bshape)
                image = torch.where(sel, image.flip(1 + ax), image)
                label = torch.where(sel, label.flip(1 + ax), label)

        do_rot = rot.get("enabled", False)
        do_scale = scale_cfg.get("enabled", False)
        if do_rot or do_scale:
            zero = torch.zeros(bsz, device=image.device)
            angle, pair_idx, scale = zero, zero.long(), zero + 1.0
            if do_rot:
                hit = u[:, 2] < rot.get("prob", 0.5)
                deg = angle_lo + (angle_hi - angle_lo) * u[:, 3]
                angle = torch.where(hit, deg * (math.pi / 180.0), zero)
                pair_idx = pick(u[:, 4], len(rot_pairs))
            if do_scale:
                hit = u[:, 5] < scale_cfg.get("prob", 0.3)
                scale = torch.where(hit, scale_lo + (scale_hi - scale_lo) * u[:, 6], zero + 1.0)
            image, label = resample(image, label, angle, pair_idx, scale, rot_pairs)

        if shift_cfg.get("enabled", False):
            do = (u[:, 7] < shift_cfg.get("prob", 0.5)).reshape(bshape)
            shift = (shift_lo + (shift_hi - shift_lo) * u[:, 8]).reshape(bshape)
            image = torch.where(do, torch.clamp(image + shift, 0.0, 1.0), image)

        if noise_cfg.get("enabled", False):
            do = (u[:, 9] < noise_cfg.get("prob", 0.3)).reshape(bshape)
            noise = sigma * torch.randn((total, *image.shape[1:]), generator=gen,
                                        device=image.device)[lo:hi]
            image = torch.where(do, torch.clamp(image + noise, 0.0, 1.0), image)
        return image[..., None], label[..., None]

    return augment_batch
