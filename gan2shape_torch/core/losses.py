"""Training losses: masked L1, second-order smoothness, discriminator
feature matching.

The batch axis holds `n` independent instances in contiguous groups of
equal size, and each loss is the (n,) vector of the per-instance losses;
n = 1, the default, is one loss over the whole batch.

A batch split into equal slices over the ranks of a process group gives
each rank a share of each loss whose mean over the ranks is the whole
batch's loss: the means are the slice's own (equal counts), and the
masked mean, whose mask sums differ from slice to slice, takes its
denominator over the group (`split`)."""

import torch

from gan2shape_torch.distributed import all_reduce_sum, world_size

EPS = 1e-7


def instance_mean(x, n=1):
    """The (n,) means of x's n leading-axis groups."""
    return x.reshape(n, -1).mean(1)


def masked_mean(x, mask, n=1, split=False):
    """The (n,) sum(x * mask) / sum(mask) of x's n leading-axis groups.
    With `split`, x is this rank's slice of a batch split over the process
    group: its share is W sum(x * mask) over the whole batch's mask sum."""
    mask = mask.expand_as(x)
    num = (x * mask).reshape(n, -1).sum(1)
    den = mask.reshape(n, -1).sum(1)
    if split:
        den = all_reduce_sum(den)
        num = num * world_size()
    return num / torch.clamp_min(den, EPS)


def photometric_loss(image1, image2, mask=None, conf_sigma=None, n=1,
                     split=False):
    loss = torch.abs(image1 - image2)
    if conf_sigma is not None:
        loss = (loss * 2 ** 0.5 / (conf_sigma + EPS)
                + torch.log(conf_sigma + EPS))
    if mask is not None:
        return masked_mean(loss, mask, n, split)
    return instance_mean(loss, n)


def _gradient(pred):
    if pred.dim() == 4:
        pred = pred.reshape(-1, pred.shape[2], pred.shape[3])
    return pred[:, :, 1:] - pred[:, :, :-1], pred[:, 1:] - pred[:, :-1]


def smooth_loss(pred_map, n=1):
    """mean |d2| over dxx, dxy, dyx, dyy, with 1/2.3 multi-scale weights."""
    if not isinstance(pred_map, (tuple, list)):
        pred_map = [pred_map]
    loss = 0.0
    weight = 1.0
    for scaled in pred_map:
        dx, dy = _gradient(scaled)
        dx2, dxdy = _gradient(dx)
        dydx, dy2 = _gradient(dy)
        loss = loss + weight * sum(instance_mean(d.abs(), n)
                                   for d in (dx2, dxdy, dydx, dy2))
        weight = weight / 2.3
    return loss


def discriminator_feature_loss(disc, fake_img, real_img, mask=None,
                               ftr_num=4, n=1):
    """L1 over the first `ftr_num` discriminator taps, with the mask
    average-pooled to each tap's resolution; the real pass carries no
    gradient."""
    with torch.no_grad():
        _, real_feats = disc(real_img, ftr_num)
    _, fake_feats = disc(fake_img, ftr_num)
    losses = []
    for rf, ff in zip(real_feats, fake_feats):
        diff = torch.abs(ff - rf)
        if mask is not None:
            b, c, h, w = diff.shape
            hm, wm = mask.shape[2], mask.shape[3]
            m = mask.reshape(mask.shape[0], mask.shape[1], h, hm // h, w,
                             wm // w).mean(dim=(3, 5))
            losses.append(masked_mean(diff, m, n))
        else:
            losses.append(instance_mean(diff, n))
    return sum(losses)
