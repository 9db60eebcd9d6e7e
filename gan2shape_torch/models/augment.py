"""Non-leaking adaptive discriminator augmentation (ADA, Karras et al. 2020),
for the StyleGAN2 trainer.

  * Random transforms are batched matrices drawn from an explicit
    `torch.Generator`: eight 3x3 geometric ones (flip, 90-degree rotation,
    integer translation, isotropic scale, pre-rotation, anisotropic scale,
    post-rotation, fractional translation) and five 4x4 colour ones
    (brightness, contrast, luma flip, hue rotation, saturation), each applied
    to a sample with probability p.
  * The geometric warp goes through the anti-aliased resampling sandwich:
    reflect-pad, SYM6 2x wavelet upsample, affine bilinear sample, SYM6
    downsample.  The reflect pad is the static maximum (w-1, h-1), as the
    JAX package has it, not the reference's per-batch dynamic pad (which it
    clamps to the same maximum): values agree wherever that dynamic pad
    covers the transformed corners.
  * The bilinear sample is a gather (`grid_sample_ac_false`), not
    `F.grid_sample`: the lazy R1 penalty differentiates through it twice,
    and `F.grid_sample`'s backward is not differentiable in its turn.
  * `AdaptiveAugment` is the reference's controller: E[sign(D(real))] moves
    p toward `ada_aug_target` in steps of n_pred / ada_aug_len every
    `update_every` updates.
"""

import math

import numpy as np
import torch
import torch.nn.functional as F

from gan2shape_torch.ops.upfirdn2d import upfirdn2d

# sym6 wavelet coefficients, used unnormalised: the up pass's gain sqrt(2)
# per axis cancels against the flipped down pass
SYM6 = np.array([
    0.015404109327027373, 0.0034907120842174702, -0.11799011114819057,
    -0.048311742585633, 0.4910559419267466, 0.787641141030194,
    0.3379294217276218, -0.07263752278646252, -0.021060292512300564,
    0.04472490177066578, 0.0017677118642428036, -0.007800708325034148,
], dtype=np.float32)


# ---------------- matrix builders (batched) ----------------

def _eye(n, b, like):
    return torch.eye(n, dtype=torch.float32,
                     device=like.device).expand(b, n, n).clone()


def translate_mat(t_x, t_y):
    m = _eye(3, t_x.shape[0], t_x)
    m[:, 0, 2] = t_x
    m[:, 1, 2] = t_y
    return m


def rotate_mat(theta):
    c, s = torch.cos(theta), torch.sin(theta)
    m = _eye(3, theta.shape[0], theta)
    m[:, 0, 0] = c
    m[:, 0, 1] = -s
    m[:, 1, 0] = s
    m[:, 1, 1] = c
    return m


def scale_mat(s_x, s_y):
    m = _eye(3, s_x.shape[0], s_x)
    m[:, 0, 0] = s_x
    m[:, 1, 1] = s_y
    return m


def translate3d_mat(t_x, t_y, t_z):
    m = _eye(4, t_x.shape[0], t_x)
    m[:, :3, 3] = torch.stack([t_x, t_y, t_z], 1)
    return m


def scale3d_mat(s_x, s_y, s_z):
    m = _eye(4, s_x.shape[0], s_x)
    m[:, 0, 0] = s_x
    m[:, 1, 1] = s_y
    m[:, 2, 2] = s_z
    return m


def rotate3d_mat(axis, theta):
    """Rodrigues rotation about `axis` (a 3-tuple), embedded in 4x4."""
    u_x, u_y, u_z = axis
    dev = theta.device
    eye = torch.eye(3, device=dev)
    cross = torch.tensor([(0, -u_z, u_y), (u_z, 0, -u_x), (-u_y, u_x, 0)],
                         dtype=torch.float32, device=dev)
    a = torch.tensor(axis, dtype=torch.float32, device=dev)
    outer = a[:, None] * a[None, :]
    s = torch.sin(theta)[:, None, None]
    c = torch.cos(theta)[:, None, None]
    rot = c * eye + s * cross + (1 - c) * outer
    m = _eye(4, theta.shape[0], theta)
    m[:, :3, :3] = rot
    return m


def luma_flip_mat(axis, i):
    """Householder reflection about the luma axis, gated by i in {0, 1}."""
    a = torch.tensor(tuple(axis) + (0.0,), dtype=torch.float32,
                     device=i.device)
    eye = _eye(4, i.shape[0], i)
    return eye - 2.0 * (a[:, None] * a[None, :]) * i[:, None, None]


def saturation_mat(axis, i):
    a = torch.tensor(tuple(axis) + (0.0,), dtype=torch.float32,
                     device=i.device)
    ao = a[:, None] * a[None, :]
    eye = _eye(4, i.shape[0], i)
    return ao + (eye - ao) * i[:, None, None]


# ---------------- random parameters ----------------

def _normal(gen, shape):
    return torch.randn(shape, generator=gen, device=gen.device)


def _uniform(gen, shape, lo, hi):
    return torch.rand(shape, generator=gen, device=gen.device) * (hi - lo) + lo


def _lognormal(gen, size, std):
    return torch.exp(_normal(gen, (size,)) * std)


def _category(gen, size, categories):
    cats = torch.tensor(categories, dtype=torch.float32, device=gen.device)
    idx = torch.randint(0, len(categories), (size,), generator=gen,
                        device=gen.device)
    return cats[idx]


def _random_apply(gen, p, transform, prev, eye):
    """`transform` on each sample with probability p (else the identity),
    composed onto `prev`."""
    size = transform.shape[0]
    sel = (torch.rand(size, generator=gen, device=gen.device) < p).float()
    sel = sel[:, None, None]
    return (sel * transform + (1 - sel) * eye) @ prev


def _as_p(p, gen):
    return torch.as_tensor(p, dtype=torch.float32, device=gen.device)


def sample_affine(gen, p, size, height, width):
    """Batch of 3x3 geometric transforms in centred pixel coordinates."""
    p = _as_p(p, gen)
    ones = torch.ones(size, device=gen.device)
    eye = _eye(3, size, ones)
    G = eye
    # flip
    param = _category(gen, size, (0, 1))
    G = _random_apply(gen, p, scale_mat(1 - 2.0 * param, ones), G, eye)
    # 90-degree rotation
    param = _category(gen, size, (0, 3))
    G = _random_apply(gen, p, rotate_mat(-math.pi / 2 * param), G, eye)
    # integer translation
    param = _uniform(gen, (2, size), -0.125, 0.125)
    G = _random_apply(gen, p, translate_mat(torch.round(param[1] * width),
                                            torch.round(param[0] * height)),
                      G, eye)
    # isotropic scale
    param = _lognormal(gen, size, 0.2 * math.log(2))
    G = _random_apply(gen, p, scale_mat(param, param), G, eye)

    p_rot = 1 - torch.sqrt(torch.clamp(1 - p, 0.0, 1.0))
    # pre-rotation
    param = _uniform(gen, (size,), -math.pi, math.pi)
    G = _random_apply(gen, p_rot, rotate_mat(-param), G, eye)
    # anisotropic scale
    param = _lognormal(gen, size, 0.2 * math.log(2))
    G = _random_apply(gen, p, scale_mat(param, 1 / param), G, eye)
    # post-rotation
    param = _uniform(gen, (size,), -math.pi, math.pi)
    G = _random_apply(gen, p_rot, rotate_mat(-param), G, eye)
    # fractional translation
    param = _normal(gen, (2, size)) * 0.125
    G = _random_apply(gen, p, translate_mat(param[1] * width,
                                            param[0] * height), G, eye)
    return G


def sample_color(gen, p, size):
    """Batch of 4x4 colour transforms."""
    p = _as_p(p, gen)
    eye = _eye(4, size, p)
    C = eye
    axis_val = 1 / math.sqrt(3)
    axis = (axis_val, axis_val, axis_val)
    # brightness
    param = _normal(gen, (size,)) * 0.2
    C = _random_apply(gen, p, translate3d_mat(param, param, param), C, eye)
    # contrast
    param = _lognormal(gen, size, 0.5 * math.log(2))
    C = _random_apply(gen, p, scale3d_mat(param, param, param), C, eye)
    # luma flip
    param = _category(gen, size, (0, 1))
    C = _random_apply(gen, p, luma_flip_mat(axis, param), C, eye)
    # hue rotation
    param = _uniform(gen, (size,), -math.pi, math.pi)
    C = _random_apply(gen, p, rotate3d_mat(axis, param), C, eye)
    # saturation
    param = _lognormal(gen, size, 1.0 * math.log(2))
    C = _random_apply(gen, p, saturation_mat(axis, param), C, eye)
    return C


# ---------------- geometric application ----------------

def _scale_single(s_x, s_y, like):
    return torch.tensor([[s_x, 0, 0], [0, s_y, 0], [0, 0, 1]],
                        dtype=like.dtype, device=like.device)


def _translate_single(t_x, t_y, like):
    return torch.tensor([[1, 0, t_x], [0, 1, t_y], [0, 0, 1]],
                        dtype=like.dtype, device=like.device)


def affine_grid_ac_false(theta, out_h, out_w):
    """`F.affine_grid(..., align_corners=False)`: output pixel centres at
    (2j+1)/W - 1 mapped through theta (B, 2, 3)."""
    kw = {"dtype": theta.dtype, "device": theta.device}
    xs = (2 * torch.arange(out_w, **kw) + 1) / out_w - 1
    ys = (2 * torch.arange(out_h, **kw) + 1) / out_h - 1
    gx = xs[None, :].expand(out_h, out_w)
    gy = ys[:, None].expand(out_h, out_w)
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)  # (H, W, 3)
    return torch.einsum("bij,hwj->bhwi", theta, base)


def grid_sample_ac_false(x, grid):
    """Bilinear sample with align_corners=False and zero padding, as four
    gathers, so that its backward (scatter-adds) is differentiable again."""
    b, c, h, w = x.shape
    _, hg, wg, _ = grid.shape
    gx = ((grid[..., 0] + 1) * w - 1) * 0.5
    gy = ((grid[..., 1] + 1) * h - 1) * 0.5
    gx = gx.reshape(b, hg * wg)
    gy = gy.reshape(b, hg * wg)

    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    wx1 = gx - x0
    wy1 = gy - y0
    ix0 = x0.long()
    iy0 = y0.long()

    xf = x.reshape(b, c, h * w)
    out = x.new_zeros(b, c, hg * wg)
    for a, wy in ((0, 1 - wy1), (1, wy1)):
        for bb, wx in ((0, 1 - wx1), (1, wx1)):
            ii = iy0 + a
            jj = ix0 + bb
            valid = (ii >= 0) & (ii <= h - 1) & (jj >= 0) & (jj <= w - 1)
            idx = torch.clamp(ii, 0, h - 1) * w + torch.clamp(jj, 0, w - 1)
            tap = torch.gather(xf, 2, idx[:, None, :].expand(b, c, -1))
            out = out + tap * ((wy * wx) * valid.to(x.dtype))[:, None, :]
    return out.reshape(b, c, hg, wg)


_KERNELS = {}


def _sym6(device):
    k = _KERNELS.get(device)
    if k is None:
        k = _KERNELS[device] = torch.as_tensor(SYM6, device=device)
    return k


def apply_affine(img, G):
    """Warp `img` (B, 3, H, W) by the inverse-transform batch `G` (B, 3, 3)
    through the anti-aliased resampling sandwich."""
    kernel = _sym6(img.device).to(img.dtype)
    len_k = int(kernel.shape[0])
    kernel_flip = torch.flip(kernel, (0,))

    b, c, h, w = img.shape
    pad_x, pad_y = w - 1, h - 1
    img_pad = F.pad(img, (pad_x, pad_x, pad_y, pad_y), mode="reflect")

    # 2x wavelet upsample, x then y; pads are (y0, y1, x0, x1)
    up_pad = ((len_k + 2 - 1) // 2, (len_k - 2) // 2)
    img_2x = upfirdn2d(img_pad, kernel.reshape(1, len_k), up=(1, 2),
                       pad=(0, 0, up_pad[0], up_pad[1]))
    img_2x = upfirdn2d(img_2x, kernel.reshape(len_k, 1), up=(2, 1),
                       pad=(up_pad[0], up_pad[1], 0, 0))

    # the symmetric pad makes the reference's centring translation identity
    G_inv = _scale_single(2, 2, G) @ G @ _scale_single(0.5, 0.5, G)
    G_inv = (_translate_single(-0.5, -0.5, G) @ G_inv
             @ _translate_single(0.5, 0.5, G))
    pad_k = len_k // 4
    out_h = (h + pad_k * 2) * 2
    out_w = (w + pad_k * 2) * 2
    h2x, w2x = img_2x.shape[2], img_2x.shape[3]
    G_inv = (_scale_single(2 / w2x, 2 / h2x, G) @ G_inv
             @ _scale_single(1 / (2 / out_w), 1 / (2 / out_h), G))

    grid = affine_grid_ac_false(G_inv[:, :2, :], out_h, out_w)
    img_affine = grid_sample_ac_false(img_2x, grid)

    d_p = -pad_k * 2
    down_pad = (d_p + (len_k - 2 + 1) // 2, d_p + (len_k - 2) // 2)
    img_down = upfirdn2d(img_affine, kernel_flip.reshape(1, len_k),
                         down=(1, 2), pad=(0, 0, down_pad[0], down_pad[1]))
    img_down = upfirdn2d(img_down, kernel_flip.reshape(len_k, 1),
                         down=(2, 1), pad=(down_pad[0], down_pad[1], 0, 0))
    return img_down


def apply_color(img, mat):
    mat_mul = mat[:, :3, :3]
    mat_add = mat[:, :3, 3]
    out = torch.einsum("boi,bihw->bohw", mat_mul, img)
    return out + mat_add[:, :, None, None]


def sample_inverse_affine(gen, p, size, height, width):
    """The inverse geometric transforms `augment` applies."""
    # inv_ex does not synchronise with the host to check for errors
    return torch.linalg.inv_ex(sample_affine(gen, p, size, height, width))[0]


def augment(gen, img, p, transforms=None):
    """Geometric then colour augmentation, each transform applied with
    probability `p` (a float or a 0-d tensor).  `transforms` = (G, C) replays
    given matrices (either may be None to draw it); G is the inverse
    geometric transform.  Returns (img_aug, (G, C))."""
    b = img.shape[0]
    G = C = None
    if transforms is not None:
        G, C = transforms
    if G is None:
        G = sample_inverse_affine(gen, p, b, img.shape[2], img.shape[3])
    if C is None:
        C = sample_color(gen, p, b)
    img = apply_affine(img, G)
    img = apply_color(img, C)
    return img, (G, C)


# ---------------- adaptive controller ----------------

class AdaptiveAugment:
    """Host-side ADA probability controller.  `tune` takes the sum of
    sign(D(real)) of one step and the batch size; every `update_every`
    updates it moves p toward keeping E[sign(D(real))] at `ada_aug_target`,
    by n_pred / ada_aug_len, clamped to [0, 1]."""

    def __init__(self, ada_aug_target=0.6, ada_aug_len=500 * 1000,
                 update_every=8):
        self.ada_aug_target = ada_aug_target
        self.ada_aug_len = ada_aug_len
        self.update_every = update_every
        self.ada_update = 0
        self.sign_sum = 0.0
        self.n_pred = 0.0
        self.r_t_stat = 0.0
        self.ada_aug_p = 0.0

    def tune(self, real_pred_sign_sum, batch_size):
        self.sign_sum += float(real_pred_sign_sum)
        self.n_pred += float(batch_size)
        self.ada_update += 1
        if self.ada_update % self.update_every == 0:
            self.r_t_stat = self.sign_sum / self.n_pred
            sign = 1 if self.r_t_stat > self.ada_aug_target else -1
            self.ada_aug_p += sign * self.n_pred / self.ada_aug_len
            self.ada_aug_p = min(1.0, max(0.0, self.ada_aug_p))
            self.sign_sum = 0.0
            self.n_pred = 0.0
            self.ada_update = 0
        return self.ada_aug_p
