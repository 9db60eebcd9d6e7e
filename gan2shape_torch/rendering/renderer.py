"""Camera intrinsics, rigid warps, depth->normals and depth-map re-rendering
under novel views (the hot path of all three method steps).

Conventions: pixel grid (x right, y down) with centers at integers;
intrinsics from fov with c = (s-1)/2; view vector (rx, ry, rz, tx, ty, tz);
rotation about the point (0, 0, rot_center_depth); screen grids normalised to
[-1, 1] by (W-1, H-1), i.e. align_corners=True.
"""

import math

import numpy as np
import torch

from gan2shape_torch.ops.grid_sample import grid_sample, grid_sample_im_mask
from gan2shape_torch.ops.rasterize import rasterize_depth

EPS = 1e-7


def get_rotation_matrix(tx, ty, tz):
    """XYZ-Euler rotation R = Rz @ Ry @ Rx; tx/ty/tz (B,) radians."""
    zeros = torch.zeros_like(tx)
    ones = torch.ones_like(tx)
    cx, sx = torch.cos(tx), torch.sin(tx)
    cy, sy = torch.cos(ty), torch.sin(ty)
    cz, sz = torch.cos(tz), torch.sin(tz)
    m_x = torch.stack([ones, zeros, zeros, zeros, cx, -sx,
                       zeros, sx, cx], -1).reshape(-1, 3, 3)
    m_y = torch.stack([cy, zeros, sy, zeros, ones, zeros,
                       -sy, zeros, cy], -1).reshape(-1, 3, 3)
    m_z = torch.stack([cz, -sz, zeros, sz, cz, zeros,
                       zeros, zeros, ones], -1).reshape(-1, 3, 3)
    return torch.matmul(m_z, torch.matmul(m_y, m_x))


def get_transform_matrices(view):
    """6/5/3-dof view vector -> (R (B, 3, 3), t (B, 1, 3))."""
    b, d = view.shape
    if d == 6:
        trans = view[:, 3:].reshape(b, 1, 3)
    elif d == 5:
        trans = torch.cat([view[:, 3:].reshape(b, 1, 2),
                           view.new_zeros((b, 1, 1))], 2)
    elif d == 3:
        trans = view.new_zeros((b, 1, 3))
    else:
        raise ValueError("view dim must be 3, 5 or 6")
    return get_rotation_matrix(view[:, 0], view[:, 1], view[:, 2]), trans


class Renderer:
    """Camera and mesh constants plus the rendering functions.  Constant
    tensors live on `device`."""

    def __init__(self, config, image_size, min_depth, max_depth,
                 device="cpu"):
        self.device = torch.device(device)
        self.image_size = image_size
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.rot_center_depth = config.get(
            "rot_center_depth", (min_depth + max_depth) / 2)
        self.fov = config.get("fov", 10)
        # grid-mode candidate window (faces are ~1 px in the training regime)
        self.raster_window = config.get("raster_window", 3)
        if config.get("raster_mode", "grid") != "grid":
            raise NotImplementedError(
                f"raster_mode {config['raster_mode']!r}: only 'grid' is "
                "ported")

        s = image_size
        f = (s - 1) / 2 / math.tan(self.fov / 2 * math.pi / 180)
        c = (s - 1) / 2
        K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]],
                     dtype=np.float32)
        inv_K = np.linalg.inv(K).astype(np.float32)
        self.K = torch.as_tensor(K, device=self.device)
        self.inv_K = torch.as_tensor(inv_K, device=self.device)
        xs, ys = np.meshgrid(np.arange(s, dtype=np.float32),
                             np.arange(s, dtype=np.float32), indexing="xy")
        self._grid_xy1 = torch.as_tensor(
            np.stack([xs, ys, np.ones_like(xs)], -1), device=self.device)
        self._centroid = torch.tensor(
            [0.0, 0.0, self.rot_center_depth], dtype=torch.float32,
            device=self.device).reshape(1, 1, 3)
        self.margin = (max_depth - min_depth) / 2

    # ---------------- geometry ----------------

    def depth_to_3d_grid(self, depth):
        """(B, H, W) depth -> (B, H, W, 3) camera-space points."""
        pts = torch.matmul(self._grid_xy1.to(depth.dtype),
                           self.inv_K.T.to(depth.dtype))
        return pts[None] * depth[..., None]

    def grid_3d_to_2d(self, grid_3d):
        """(B, H, W, 3) points -> normalised [-1, 1] screen grid."""
        b, h, w, _ = grid_3d.shape
        g = grid_3d / grid_3d[..., 2:]
        g = torch.matmul(g, self.K.T.to(grid_3d.dtype))
        wh = torch.tensor([w - 1, h - 1], dtype=grid_3d.dtype,
                          device=grid_3d.device)
        return g[..., :2] / wh * 2.0 - 1.0

    def rotate_pts(self, pts, rot_mat):
        c = self._centroid.to(pts.dtype)
        return torch.matmul(pts - c, rot_mat.transpose(1, 2)) + c

    def translate_pts(self, pts, trans_xyz):
        return pts + trans_xyz

    def get_warped_3d_grid(self, depth, rot_mat, trans_xyz):
        b, h, w = depth.shape
        pts = self.depth_to_3d_grid(depth).reshape(b, -1, 3)
        pts = self.translate_pts(self.rotate_pts(pts, rot_mat), trans_xyz)
        return pts.reshape(b, h, w, 3)

    def get_inv_warped_3d_grid(self, depth, rot_mat, trans_xyz):
        b, h, w = depth.shape
        pts = self.depth_to_3d_grid(depth).reshape(b, -1, 3)
        pts = self.translate_pts(pts, -trans_xyz)
        pts = self.rotate_pts(pts, rot_mat.transpose(1, 2))
        return pts.reshape(b, h, w, 3)

    def get_warped_2d_grid(self, depth, rot_mat, trans_xyz):
        return self.grid_3d_to_2d(
            self.get_warped_3d_grid(depth, rot_mat, trans_xyz))

    def get_inv_warped_2d_grid(self, depth, rot_mat, trans_xyz):
        return self.grid_3d_to_2d(
            self.get_inv_warped_3d_grid(depth, rot_mat, trans_xyz))

    # ---------------- rasterization ----------------

    def _project_screen(self, pts):
        """Camera-space points (B, N, 3) -> pixel screen coords + depth."""
        proj = torch.matmul(pts, self.K.T.to(pts.dtype))
        z = torch.clamp_min(proj[..., 2], 1e-6)
        return proj[..., 0] / z, proj[..., 1] / z, pts[..., 2]

    def warp_canon_depth(self, canon_depth, rot_mat, trans_xyz):
        """Re-render the canonical depth under a view, clamped to the depth
        range widened by the margin."""
        b, h, w = canon_depth.shape
        pts = self.get_warped_3d_grid(canon_depth, rot_mat,
                                      trans_xyz).reshape(b, -1, 3)
        xs, ys, zs = self._project_screen(pts)
        lo = self.min_depth - self.margin
        hi = self.max_depth + self.margin
        depth = rasterize_depth(xs, ys, zs, h, w, window=self.raster_window,
                                near=lo, far=hi)
        return torch.clamp(depth, lo, hi)

    # ---------------- normals ----------------

    def get_normal_from_depth(self, depth):
        """Central-difference surface normals; border rows/cols get z-hat."""
        b, h, w = depth.shape
        grid_3d = self.depth_to_3d_grid(depth)
        tu = grid_3d[:, 1:-1, 2:] - grid_3d[:, 1:-1, :-2]
        tv = grid_3d[:, 2:, 1:-1] - grid_3d[:, :-2, 1:-1]
        normal = torch.cross(tu, tv, dim=-1)
        zhat = torch.tensor([0.0, 0.0, 1.0], dtype=depth.dtype,
                            device=depth.device)
        normal = torch.cat([zhat.expand(b, h - 2, 1, 3), normal,
                            zhat.expand(b, h - 2, 1, 3)], 2)
        normal = torch.cat([zhat.expand(b, 1, w, 3), normal,
                            zhat.expand(b, 1, w, 3)], 1)
        return normal / (torch.linalg.vector_norm(normal, dim=3, keepdim=True)
                         + EPS)

    # ---------------- view synthesis ----------------

    def render_given_view(self, im, depth, view, mask=None):
        """Render image (+ mask) under `view` by warping the depth,
        inverse-warping a sampling grid and grid-sampling (the grid_sample
        mode of the reference; mesh-texture rendering is not ported)."""
        rot_mat, trans_xyz = get_transform_matrices(view)
        recon_depth = self.warp_canon_depth(depth, rot_mat, trans_xyz)
        grid = self.get_inv_warped_2d_grid(recon_depth, rot_mat, trans_xyz)
        if mask is not None:
            return grid_sample_im_mask(im, mask, grid)
        return grid_sample(im, grid, mode="bilinear")
