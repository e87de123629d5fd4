"""Inputs of the ``abdomenmrct-task1`` configuration: intra-patient
abdominal MR/CT pairs with organ labels and a body mask, made on the device
from the seed.

Each pair is one subject.  Its anatomy is a set of tissue classes on the
volume's grid: air, an elliptic body with a ring of subcutaneous fat, soft
tissue inside it, a spine, and four organs (liver, spleen, left and right
kidney; labels 1-4) as ellipsoids of seeded centre and size, all read
through a smooth field of up to ``anatomy_max_vox`` voxels that bends them
out of shape.  A smooth texture (one for the subject) varies the tissue
inside the body.

The fixed image is the subject's MR: each class's MR value
(``tissues[k][1]``), the texture, a smooth multiplicative bias field and
Gaussian noise.  The moving image is its CT in HU (``tissues[k][0]``, the
texture, noise) pulled back by a smooth field of up to ``warp_max_vox``
voxels: ``moving(y) = ct(y + w(y))``, as are the moving labels.  Fat is
bright in MR and dark in CT, bone the reverse, and the organs' order
differs between the two, so MR is no monotone map of CT and MIND-SSC does
real multimodal work.  The fixed mask is the fixed subject's body.  Every
size is the configuration's, so the seed changes the answers, not the
amount of work.
"""

from __future__ import annotations

import torch

from rb.synth import identity, sample_at, scale_to, upsample_field

#: tissue classes, in the order the volume of classes holds them
CLASSES = ("air", "fat", "soft", "bone", "liver", "spleen", "kidney", "kidney")
ORGANS = {"liver": 4, "spleen": 5, "left kidney": 6, "right kidney": 7}
#: organ centres and semi-axes as fractions of the volume's extent (axis 0
#: left-right, 1 anterior-posterior, 2 cranio-caudal)
ORGAN_SHAPES = {
    "liver": ((0.34, 0.45, 0.62), (0.17, 0.22, 0.20)),
    "spleen": ((0.70, 0.58, 0.66), (0.06, 0.10, 0.11)),
    "left kidney": ((0.64, 0.66, 0.44), (0.055, 0.07, 0.11)),
    "right kidney": ((0.36, 0.66, 0.42), (0.055, 0.07, 0.11)),
}
#: random numbers a subject reads: two body scales, then a centre jitter
#: and an axis scale of three each per organ
N_UNIFORM = 2 + 6 * len(ORGAN_SHAPES)


def _classes(shape, cfg, u, bend: torch.Tensor, device) -> torch.Tensor:
    """The subject's tissue classes (H, W, D) int64, indices into
    :data:`CLASSES`, every random choice read from ``u`` in order."""
    H, W, D = shape
    pos = identity(shape, device) + bend
    ext = torch.tensor([H, W, D], dtype=torch.float32, device=device).reshape(3, 1, 1, 1)
    rel = pos / ext  # fractions of the extent
    ax0, ax1 = 0.43 * (0.95 + 0.1 * u[0]), 0.36 * (0.95 + 0.1 * u[1])
    ring = ((rel[0] - 0.5) / ax0) ** 2 + ((rel[1] - 0.5) / ax1) ** 2
    cls = torch.zeros(shape, dtype=torch.int64, device=device)
    cls[ring <= 1.0] = 1
    cls[ring <= 0.81] = 2
    spine = ((pos[0] - H / 2) / 10.0) ** 2 + ((pos[1] - 0.71 * W) / 10.0) ** 2 <= 1.0
    cls[spine] = 3
    k = 2
    for name, (c, a) in ORGAN_SHAPES.items():
        c = [c[i] + 0.04 * (float(u[k + i]) - 0.5) for i in range(3)]
        a = [a[i] * (0.9 + 0.2 * float(u[k + 3 + i])) for i in range(3)]
        k += 6
        inside = sum(((rel[i] - c[i]) / a[i]) ** 2 for i in range(3)) <= 1.0
        cls[inside & (ring <= 0.81)] = ORGANS[name]
    return cls


def _table(cfg, col: int, device) -> torch.Tensor:
    t = cfg["tissues"]
    return torch.tensor([t[c][col] for c in CLASSES], dtype=torch.float32, device=device)


def make(config: dict, seed: int, device) -> dict:
    """``imgs_fixed`` (MR) and ``imgs_moving`` (CT) (pairs, H, W, D)
    float32, ``masks`` (the fixed body) float32, ``segs_fixed`` and
    ``segs_moving`` int32 (labels 1-4), as host arrays; ``num_labels``, the
    preprocessed ``spacing`` and the ``original`` grid of every pair
    (fields of the program's ``Task1CaseMeta``)."""
    shape = tuple(config["shape"])
    P = int(config["pairs"])
    g = torch.Generator(device=device).manual_seed(int(seed))
    u_all = torch.rand((P, N_UNIFORM), generator=g, device=device).cpu()
    ct_tab, mr_tab = _table(config, 0, device), _table(config, 1, device)
    to_label = torch.zeros(len(CLASSES), dtype=torch.int64, device=device)
    to_label[4:] = torch.arange(1, 5, device=device)
    tex_ct, tex_mr = config["texture"]
    sig_ct, sig_mr = config["noise_sigma"]
    air = float(config["tissues"]["air"][0])
    out = {k: [] for k in ("imgs_fixed", "imgs_moving", "masks", "segs_fixed", "segs_moving")}
    for p in range(P):
        bend = scale_to(upsample_field(
            torch.randn((3,) + tuple(config["anatomy_ctrl"]), generator=g, device=device),
            shape), float(config["anatomy_max_vox"]))
        cls = _classes(shape, config, u_all[p], bend, device)
        del bend
        body = cls > 0
        tex = scale_to(upsample_field(
            torch.randn((1,) + tuple(config["texture_ctrl"]), generator=g, device=device),
            shape), 1.0)[0] * body
        bias = 1.0 + scale_to(upsample_field(
            torch.randn((1,) + tuple(config["bias_ctrl"]), generator=g, device=device), shape),
            float(config["bias_max"]))[0]
        w = scale_to(upsample_field(
            torch.randn((3,) + tuple(config["warp_ctrl"]), generator=g, device=device), shape),
            float(config["warp_max_vox"]))
        mr = (mr_tab[cls] + tex_mr * tex) * bias
        mr = mr + sig_mr * torch.randn(shape, generator=g, device=device)
        ct = ct_tab[cls] + tex_ct * tex
        at = identity(shape, device) + w
        # a point pulled from outside the volume sees air, as a scanner would
        ct = sample_at(ct - air, at, "bilinear") + air
        ct = ct + sig_ct * torch.randn(shape, generator=g, device=device)
        labels = to_label[cls]
        moved = sample_at(labels.float(), at, "nearest").round().to(torch.int32)
        out["imgs_fixed"].append(mr.cpu())
        out["imgs_moving"].append(ct.cpu())
        out["masks"].append(body.float().cpu())
        out["segs_fixed"].append(labels.to(torch.int32).cpu())
        out["segs_moving"].append(moved.cpu())
        del cls, body, tex, bias, w, mr, ct, at, labels, moved
    orig = config["original"]
    o_shape = [int(n) for n in orig["shape"]]
    whole = ((0.0, 0.0, 0.0), tuple(float(n) for n in o_shape))
    o_sp = tuple(float(v) for v in orig["spacing_mm"])
    res = {k: torch.stack(v).numpy() for k, v in out.items()}
    res.update(num_labels=int(config["labels"]),
               spacing=tuple(float(v) for v in config["spacing_mm"]),
               original=dict(fix_shape=tuple(o_shape), fix_spacing=o_sp, fix_crop=whole,
                             mov_shape=tuple(o_shape), mov_spacing=o_sp, mov_crop=whole,
                             ref_spacing=tuple(float(v) for v in config["spacing_mm"]),
                             flip=orig["flip"]))
    return res
