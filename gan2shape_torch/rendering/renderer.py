"""Camera intrinsics, rigid warps, depth->normals and depth-map re-rendering
under novel views (the hot path of all three method steps), and the
mesh-RGB renders and yaw/pitch sweeps used for visualisation.

Every matmul here is `exact_matmul`: geometry stays exact f32, forward and
backward, under every precision policy (utils/precision.py).

Conventions: pixel grid (x right, y down) with centers at integers;
intrinsics from fov with c = (s-1)/2; view vector (rx, ry, rz, tx, ty, tz);
rotation about the point (0, 0, rot_center_depth); screen grids normalised to
[-1, 1] by (W-1, H-1), i.e. align_corners=True.

Spans (`diagnostics.span`, recorded only while a torch profiler runs):
`g2s.render.warp` around `warp_canon_depth`, `g2s.render.grid` around
`get_inv_warped_2d_grid`, `g2s.render.view` around `render_given_view`.
"""

import math

import numpy as np
import torch

from gan2shape_torch.device import resolve_device
from gan2shape_torch.ops.grid_sample import grid_sample, grid_sample_im_mask
from gan2shape_torch.ops.rasterize import (
    grid_faces, rasterize_attributes, rasterize_depth,
)
from gan2shape_torch.utils.precision import exact_matmul

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
    return exact_matmul(m_z, exact_matmul(m_y, m_x))


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
    tensors live on `device`: CUDA unless the caller asks for the CPU
    (`resolve_device`)."""

    def __init__(self, config, image_size, min_depth, max_depth,
                 device=None):
        # imported here: the core package imports this module
        from gan2shape_torch.core.diagnostics import span
        self.span = span
        self.device = resolve_device(device)
        self.image_size = image_size
        self.min_depth = min_depth
        self.max_depth = max_depth
        self.rot_center_depth = config.get(
            "rot_center_depth", (min_depth + max_depth) / 2)
        self.fov = config.get("fov", 10)
        # depth range of the mesh-RGB renders
        self.renderer_min_depth = config.get("renderer_min_depth", 0.1)
        self.renderer_max_depth = config.get("renderer_max_depth", 10.0)
        # grid-mode candidate window (faces are ~1 px in the training regime);
        # the other modes keep at least the exact z-buffer's reach of 5
        self.raster_window = config.get("raster_window", 3)
        # 'grid', 'scatter' or 'invwarp' (ops/rasterize.py)
        self.raster_mode = config.get("raster_mode", "grid")
        self.raster_search = config.get("raster_search", 2)

        s = image_size
        f = (s - 1) / 2 / math.tan(self.fov / 2 * math.pi / 180)
        c = (s - 1) / 2
        K = np.array([[f, 0.0, c], [0.0, f, c], [0.0, 0.0, 1.0]],
                     dtype=np.float32)
        inv_K = np.linalg.inv(K).astype(np.float32)
        self.K = torch.as_tensor(K, device=self.device)
        self.inv_K = torch.as_tensor(inv_K, device=self.device)
        self.faces = torch.as_tensor(grid_faces(s, s),
                                     device=self.device).long()
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
        pts = exact_matmul(self._grid_xy1.to(depth.dtype),
                           self.inv_K.T.to(depth.dtype))
        return pts[None] * depth[..., None]

    def grid_3d_to_2d(self, grid_3d):
        """(B, H, W, 3) points -> normalised [-1, 1] screen grid."""
        b, h, w, _ = grid_3d.shape
        g = grid_3d / grid_3d[..., 2:]
        g = exact_matmul(g, self.K.T.to(grid_3d.dtype))
        wh = torch.tensor([w - 1, h - 1], dtype=grid_3d.dtype,
                          device=grid_3d.device)
        return g[..., :2] / wh * 2.0 - 1.0

    def rotate_pts(self, pts, rot_mat):
        c = self._centroid.to(pts.dtype)
        return exact_matmul(pts - c, rot_mat.transpose(1, 2)) + c

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
        with self.span("render.grid"):
            return self.grid_3d_to_2d(
                self.get_inv_warped_3d_grid(depth, rot_mat, trans_xyz))

    # ---------------- rasterization ----------------

    def _project_screen(self, pts):
        """Camera-space points (B, N, 3) -> pixel screen coords + depth."""
        proj = exact_matmul(pts, self.K.T.to(pts.dtype))
        z = torch.clamp_min(proj[..., 2], 1e-6)
        return proj[..., 0] / z, proj[..., 1] / z, pts[..., 2]

    def warp_canon_depth(self, canon_depth, rot_mat, trans_xyz,
                         raster_mode=None):
        """Re-render the canonical depth under a view, clamped to the depth
        range widened by the margin."""
        b, h, w = canon_depth.shape
        with self.span("render.warp"):
            pts = self.get_warped_3d_grid(canon_depth, rot_mat,
                                          trans_xyz).reshape(b, -1, 3)
            xs, ys, zs = self._project_screen(pts)
            mode = raster_mode or self.raster_mode
            window = self.raster_window if mode == "grid" \
                else max(self.raster_window, 5)
            lo = self.min_depth - self.margin
            hi = self.max_depth + self.margin
            depth = rasterize_depth(xs, ys, zs, self.faces, h, w,
                                    window=window, near=lo, far=hi,
                                    mode=mode, search=self.raster_search)
            return torch.clamp(depth, lo, hi)

    def render_mesh_rgb(self, im, pts, mask=None, background=1.0):
        """Rasterize an image (B, C, H, W) as the vertex colours of the mesh
        of camera-space points `pts` (B, H*W, 3) or (B, H, W, 3) through the
        exact z-buffer.  Returns the image clipped to [-1, 1] and the
        coverage, or, given a mask, the mask rendered the same way over
        background 0."""
        b, c, h, w = im.shape
        xs, ys, zs = self._project_screen(pts.reshape(b, -1, 3))
        window = max(self.raster_window, 5)

        def render(attrs, background):
            return rasterize_attributes(
                xs, ys, zs, attrs.permute(0, 2, 3, 1).reshape(b, h * w, -1),
                self.faces, h, w, window=window, near=self.renderer_min_depth,
                far=self.renderer_max_depth, background=background)

        img, cov = render(im, background)
        img = torch.clamp(img, -1.0, 1.0)
        if mask is not None:
            return img, torch.clamp(render(mask, 0.0)[0], -1.0, 1.0)
        return img, cov

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

    def render_given_view(self, im, depth, view, mask=None,
                          grid_sample_mode=True, raster_mode=None):
        """Render image (+ mask) under `view`.  grid_sample_mode: warp the
        depth, inverse-warp a sampling grid and grid-sample (the training
        path); otherwise rasterize the image as the warped mesh's vertex
        colours."""
        with self.span("render.view"):
            rot_mat, trans_xyz = get_transform_matrices(view)
            if grid_sample_mode:
                recon_depth = self.warp_canon_depth(
                    depth, rot_mat, trans_xyz, raster_mode=raster_mode)
                grid = self.get_inv_warped_2d_grid(recon_depth, rot_mat,
                                                   trans_xyz)
                if mask is not None:
                    return grid_sample_im_mask(im, mask, grid)
                return grid_sample(im, grid, mode="bilinear")
            pts = self.get_warped_3d_grid(depth, rot_mat, trans_xyz)
            img, m = self.render_mesh_rgb(im, pts, mask=mask)
            return (img, m) if mask is not None else img

    def _sweep(self, im, depth, axis, angles, v_before, v_after,
               grid_sample_mode, grid_3d):
        """Frames (B, T, C, H, W) rotated by each angle about x (axis 0) or
        y (axis 1): grid-sampled through the 'scatter' depth, or the mesh
        `grid_3d` (B, N, 3) in the v_before frame rendered in colour."""
        b = im.shape[0]
        frames = []
        for angle in angles:
            rvec = [0.0] * 3
            rvec[axis] = angle
            if grid_sample_mode:
                view = im.new_tensor(rvec + [0.0] * 3).reshape(1, 6)
                if v_before is not None:
                    view = view - v_before
                frames.append(self.render_given_view(
                    im, depth, view, raster_mode="scatter"))
                continue
            rot, _ = get_transform_matrices(im.new_tensor(rvec).reshape(1, 3))
            pts = self.rotate_pts(grid_3d, rot.expand(b, 3, 3))
            if v_after is not None:
                rot_a, trans_a = get_transform_matrices(v_after)
                pts = self.translate_pts(self.rotate_pts(pts, rot_a), trans_a)
            frames.append(self.render_mesh_rgb(im, pts)[0])
        return torch.stack(frames, 1)

    def _sweep_mesh(self, depth, v_before, crop_mesh=None):
        """The depth's camera-space mesh (B, N, 3), border-flattened by
        `crop_mesh` and brought into the v_before frame."""
        b = depth.shape[0]
        grid_3d = self.depth_to_3d_grid(depth)
        if crop_mesh is not None:
            grid_3d = _apply_crop_mesh(grid_3d, crop_mesh)
        grid_3d = grid_3d.reshape(b, -1, 3)
        if v_before is not None:
            rot_mat, trans_xyz = get_transform_matrices(v_before)
            grid_3d = self.rotate_pts(self.translate_pts(grid_3d, -trans_xyz),
                                      rot_mat.transpose(1, 2))
        return grid_3d

    def render_yaw(self, im, depth, v_before=None, v_after=None,
                   rotations=None, maxr=90, nsample=9, grid_sample_mode=False,
                   crop_mesh=None):
        """Yaw sweep for visualisation: (B, T, C, H, W), T = nsample angles
        over [-maxr, maxr] degrees unless `rotations` (radians) are given."""
        if rotations is None:
            rotations = np.linspace(-math.pi / 180 * maxr,
                                    math.pi / 180 * maxr, nsample)
        grid_3d = self._sweep_mesh(depth, v_before, crop_mesh)
        return self._sweep(im, depth, 1, np.asarray(rotations), v_before,
                           v_after, grid_sample_mode, grid_3d)

    def render_view(self, im, depth, v_before=None, maxr=(20, 90),
                    nsample=(5, 9), grid_sample_mode=False):
        """A yaw sweep then a pitch sweep, concatenated on the frame axis."""
        yaw = self.render_yaw(im, depth, v_before=v_before, maxr=maxr[1],
                              nsample=nsample[1],
                              grid_sample_mode=grid_sample_mode)
        rot_p = np.linspace(-math.pi / 180 * maxr[0], math.pi / 180 * maxr[0],
                            nsample[0])
        pitch = self._sweep(im, depth, 0, rot_p, v_before, None,
                            grid_sample_mode,
                            self._sweep_mesh(depth, v_before))
        return torch.cat([yaw, pitch], 1)


def _apply_crop_mesh(grid_3d, crop_mesh):
    """Flatten the border geometry before a sweep: the `top` / `bottom` rows
    take the y and z of the first row inside, the `left` / `right` columns
    the x and z of the first column inside."""
    top, bottom, left, right = crop_mesh
    g = grid_3d.clone()
    if top > 0:
        g[:, :top, :, 1:] = g[:, top:top + 1, :, 1:].clone()
    if bottom > 0:
        g[:, -bottom:, :, 1:] = g[:, -bottom - 1:-bottom, :, 1:].clone()
    if left > 0:
        g[:, :, :left, ::2] = g[:, :, left:left + 1, ::2].clone()
    if right > 0:
        g[:, :, -right:, ::2] = g[:, :, -right - 1:-right, ::2].clone()
    return g
