"""Training losses: masked L1, second-order smoothness, discriminator
feature matching."""

import torch

EPS = 1e-7


def photometric_loss(image1, image2, mask=None, conf_sigma=None):
    loss = torch.abs(image1 - image2)
    if conf_sigma is not None:
        loss = (loss * 2 ** 0.5 / (conf_sigma + EPS)
                + torch.log(conf_sigma + EPS))
    if mask is not None:
        mask = mask.expand_as(loss)
        return torch.sum(loss * mask) / torch.clamp_min(torch.sum(mask), EPS)
    return torch.mean(loss)


def _gradient(pred):
    if pred.dim() == 4:
        pred = pred.reshape(-1, pred.shape[2], pred.shape[3])
    return pred[:, :, 1:] - pred[:, :, :-1], pred[:, 1:] - pred[:, :-1]


def smooth_loss(pred_map):
    """mean |d2| over dxx, dxy, dyx, dyy, with 1/2.3 multi-scale weights."""
    if not isinstance(pred_map, (tuple, list)):
        pred_map = [pred_map]
    loss = 0.0
    weight = 1.0
    for scaled in pred_map:
        dx, dy = _gradient(scaled)
        dx2, dxdy = _gradient(dx)
        dydx, dy2 = _gradient(dy)
        loss = loss + weight * (dx2.abs().mean() + dxdy.abs().mean()
                                + dydx.abs().mean() + dy2.abs().mean())
        weight = weight / 2.3
    return loss


def discriminator_feature_loss(disc, fake_img, real_img, mask=None,
                               ftr_num=4):
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
                             wm // w).mean(dim=(3, 5)).expand_as(diff)
            losses.append(torch.sum(diff * m)
                          / torch.clamp_min(torch.sum(m), EPS))
        else:
            losses.append(torch.mean(diff))
    return sum(losses)
