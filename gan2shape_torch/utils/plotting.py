"""Visualization: depth-map plots, reconstruction grids, rotating-3D-surface
animations and the results gallery.  Inputs are numpy arrays (callers move
tensors to the host first).

matplotlib (optional) renders the static plots and, with Pillow, the
rotating GIF; without matplotlib those plots are skipped.  The 3D surface
HTML uses plotly when importable and otherwise a self-contained canvas
viewer, so it is always written."""

import logging
import os

import numpy as np

log = logging.getLogger(__name__)

try:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
except Exception:  # pragma: no cover
    plt = None

try:
    import plotly.graph_objects as go
except Exception:
    go = None


def _ensure_dirs():
    os.makedirs("results/plots", exist_ok=True)
    os.makedirs("results/htmls", exist_ok=True)


def to_image(t):
    """(C,H,W) [-1,1] -> (H,W,C) [0,1]"""
    arr = np.asarray(t)
    if arr.ndim == 4:
        arr = arr[0]
    if arr.shape[0] in (1, 3):
        arr = arr.transpose(1, 2, 0)
    return np.clip(arr / 2 + 0.5, 0, 1)


def plot_predicted_depth_map(depth, image_size=128, img_idx=0, save=True,
                             filename="depth", block=False):
    """(reference plotting.py:133-150)"""
    if plt is None:
        return
    _ensure_dirs()
    depth = np.asarray(depth).reshape(-1, image_size, image_size)[0]
    fig, ax = plt.subplots()
    im = ax.imshow(depth, cmap="viridis")
    fig.colorbar(im)
    if save:
        fig.savefig(f"results/plots/{filename}_{img_idx}.png", dpi=120)
    plt.close(fig)


def plot_reconstructions(recon_im, recon_depth, total_it="", im_idx="",
                         stage="", epoch=""):
    """Side-by-side reconstruction + depth (reference plotting.py:153-187)."""
    if plt is None:
        return
    _ensure_dirs()
    img = to_image(recon_im)
    depth = np.asarray(recon_depth)
    if depth.ndim == 3:
        depth = depth[0]
    fig, axes = plt.subplots(1, 2, figsize=(8, 4))
    axes[0].imshow(img)
    axes[0].set_title("reconstruction")
    d = axes[1].imshow(depth, cmap="viridis")
    axes[1].set_title("depth")
    fig.colorbar(d, ax=axes[1])
    tag = f"it_{total_it}_im_{im_idx}" + (f"_stage_{stage}" if stage else "") \
        + (f"_epoch_{epoch}" if epoch else "")
    fig.savefig(f"results/plots/recon_{tag}.png", dpi=120)
    plt.close(fig)


def plot_3d_depth(depth, image=None, img_idx=0, n_frames=18,
                  save_html=True, save_gif=True):
    """Rotating 3D surface of a depth map (reference plotly_3d_animate,
    plotting.py:58-130).  NaNs in `depth` mark masked-out background."""
    _ensure_dirs()
    depth = np.asarray(depth, np.float32)
    if depth.ndim == 3:
        depth = depth[0]
    z = -depth  # near = up
    h, w = z.shape
    colors = None
    if image is not None:
        colors = to_image(image)

    if save_html:
        path = f"results/htmls/depth_{img_idx}.html"
        if go is not None:
            surf = go.Surface(z=z, surfacecolor=None if colors is None
                              else colors.mean(-1))
            fig = go.Figure(data=[surf])
            fig.write_html(path)
        else:
            # without plotly: a self-contained rotating-3D-surface HTML
            # (inline canvas renderer, no external dependencies)
            write_3d_html(z, colors, path)
        log.info("wrote %s", path)

    if plt is None or not save_gif:
        return
    try:
        from PIL import Image as PILImage
    except ImportError:
        log.warning("Pillow not installed: no rotating GIF for image %s",
                    img_idx)
        return
    frames = []
    yy, xx = np.mgrid[0:h, 0:w]
    for i in range(n_frames):
        fig = plt.figure(figsize=(4, 4))
        ax = fig.add_subplot(111, projection="3d")
        fc = None if colors is None else colors.reshape(-1, colors.shape[-1])
        ax.plot_surface(xx, yy, z, cmap=None if colors is not None else "viridis",
                        facecolors=None if colors is None else colors,
                        rstride=4, cstride=4, linewidth=0, antialiased=False)
        ax.view_init(elev=60, azim=i * 360 / n_frames)
        ax.set_axis_off()
        fig.canvas.draw()
        buf = np.asarray(fig.canvas.buffer_rgba())[..., :3]
        frames.append(PILImage.fromarray(buf))
        plt.close(fig)
    path = f"results/plots/depth3d_{img_idx}.gif"
    frames[0].save(path, save_all=True, append_images=frames[1:],
                   duration=120, loop=0)
    log.info("wrote %s", path)


def write_3d_html(z, colors, path, max_side=96):
    """Self-contained rotating-3D-surface HTML viewer (no plotly, no external
    assets): embeds the height field + optional vertex colors as JSON and
    renders with a painter's-algorithm quad rasterizer on a <canvas>.
    Drag to orbit; auto-rotates like the reference's plotly animation."""
    z = np.asarray(z, np.float32)
    h, w = z.shape
    step = max(1, int(np.ceil(max(h, w) / max_side)))
    z = z[::step, ::step]
    finite = np.isfinite(z)
    zmin = float(np.nanmin(z)) if finite.any() else 0.0
    zmax = float(np.nanmax(z)) if finite.any() else 1.0
    zn = np.where(finite, (z - zmin) / max(zmax - zmin, 1e-9), np.nan)
    col = None
    if colors is not None:
        c = np.asarray(colors)[::step, ::step]
        col = np.clip(c.reshape(c.shape[0], c.shape[1], -1)[..., :3] * 255,
                      0, 255).astype(np.uint8).tolist()
    payload = {
        "z": [[None if not np.isfinite(v) else round(float(v), 4)
               for v in row] for row in zn],
        "c": col,
    }
    import json as _json
    html = """<!doctype html><meta charset="utf-8">
<title>depth surface</title>
<style>body{margin:0;background:#111;color:#ccc;font:13px sans-serif}
#c{display:block;margin:auto}</style>
<canvas id="c" width="720" height="720"></canvas>
<div style="text-align:center">drag to orbit &middot; auto-rotates</div>
<script>
const D=DATA;const Z=D.z,C=D.c,H=Z.length,W=Z[0].length;
const cv=document.getElementById('c'),g=cv.getContext('2d');
let yaw=0,pitch=-1.0,drag=null,auto=true;
cv.onmousedown=e=>{drag=[e.clientX,e.clientY];auto=false};
window.onmouseup=()=>drag=null;
window.onmousemove=e=>{if(!drag)return;yaw+=(e.clientX-drag[0])*.01;
pitch+=(e.clientY-drag[1])*.01;drag=[e.clientX,e.clientY];};
function render(){
g.fillStyle='#111';g.fillRect(0,0,720,720);
const cy=Math.cos(yaw),sy=Math.sin(yaw),cp=Math.cos(pitch),sp=Math.sin(pitch);
const s=620/Math.max(H,W);const quads=[];
function pr(i,j){const zv=Z[i][j];if(zv===null)return null;
let x=(j-W/2)*s,y=(i-H/2)*s,zz=(zv-0.5)*220;
let x1=x*cy+zz*sy, z1=-x*sy+zz*cy;
let y1=y*cp+z1*sp, z2=-y*sp+z1*cp;
return [x1+360,y1+360,z2,zv];}
for(let i=0;i<H-1;i++)for(let j=0;j<W-1;j++){
const a=pr(i,j),b=pr(i,j+1),c2=pr(i+1,j+1),d=pr(i+1,j);
if(!a||!b||!c2||!d)continue;
quads.push([(a[2]+b[2]+c2[2]+d[2])/4,a,b,c2,d,i,j]);}
quads.sort((p,q)=>p[0]-q[0]);
for(const[_,a,b,c2,d,i,j]of quads){
let col;if(C){const cc=C[i][j];col=`rgb(${cc[0]},${cc[1]},${cc[2]})`;}
else{const t=a[3];col=`hsl(${240-t*240},70%,${30+t*40}%)`;}
g.fillStyle=col;g.beginPath();g.moveTo(a[0],a[1]);g.lineTo(b[0],b[1]);
g.lineTo(c2[0],c2[1]);g.lineTo(d[0],d[1]);g.closePath();g.fill();}
if(auto)yaw+=0.015;requestAnimationFrame(render);}
render();
</script>"""
    html = html.replace("DATA", _json.dumps(payload))
    with open(path, "w") as f:
        f.write(html)


def plot_originals_v_reconstructions(originals, reconstructions, n=4):
    if plt is None:
        return
    _ensure_dirs()
    n = min(n, len(originals))
    fig, axes = plt.subplots(2, n, figsize=(3 * n, 6))
    axes = np.atleast_2d(axes)
    for i in range(n):
        axes[0, i].imshow(to_image(originals[i]))
        axes[1, i].imshow(to_image(reconstructions[i]))
        axes[0, i].set_axis_off()
        axes[1, i].set_axis_off()
    fig.savefig("results/plots/originals_v_reconstructions.png", dpi=120)
    plt.close(fig)


def make_gallery(results_dir="results", title="GAN2Shape Results"):
    """Assemble the per-image artifacts (interactive 3D HTML viewers,
    reconstruction plots, rotating GIFs) into one results/index.html —
    the reference's qualitative gallery (reference README.md:4-11,
    docs/index.html).  Self-contained collapsible sections (no CDN
    dependencies, unlike the reference's Bootstrap/Vue page) with the
    interactive viewers embedded via <object> exactly like docs/index.html.

    Returns the gallery path, or None when there is nothing to collect."""
    import glob
    import re

    htmls = sorted(glob.glob(os.path.join(results_dir, "htmls",
                                          "depth_*.html")))
    if not htmls:
        log.warning("make_gallery: no per-image htmls under %s", results_dir)
        return None

    def idx_of(p):
        m = re.search(r"depth_(\w+)\.html$", p)
        return m.group(1) if m else p

    sections = []
    for p in htmls:
        idx = idx_of(p)
        rel_html = os.path.relpath(p, results_dir)
        gif = os.path.join(results_dir, "plots", f"depth3d_{idx}.gif")
        recons = sorted(glob.glob(os.path.join(
            results_dir, "plots", f"recon_*_im_{idx}*.png")))
        media = [f'<object data="{rel_html}" style="height:50vh;'
                 f'width:45vw""></object>']
        if os.path.exists(gif):
            media.append(f'<img src="plots/depth3d_{idx}.gif" '
                         f'style="height:30vh">')
        if recons:
            media.append(f'<img src="{os.path.relpath(recons[-1], results_dir)}"'
                         f' style="height:30vh">')
        sections.append(
            f"<details open><summary>image {idx}</summary>"
            f"<div class='row'>{''.join(media)}</div></details>")

    extra = ""
    ovr = os.path.join(results_dir, "plots",
                       "originals_v_reconstructions.png")
    if os.path.exists(ovr):
        extra = ("<details open><summary>originals vs reconstructions"
                 "</summary><img src='plots/originals_v_reconstructions.png'"
                 " style='max-width:90vw'></details>")

    html = f"""<!doctype html><meta charset="utf-8">
<title>{title}</title>
<style>body{{font:15px sans-serif;margin:2em;background:#fafafa}}
summary{{font-size:1.2em;cursor:pointer;padding:.3em 0}}
.row{{display:flex;flex-wrap:wrap;gap:1em;align-items:center}}
details{{border-bottom:1px solid #ddd;padding:.5em 0}}</style>
<h1>{title}</h1>
<p>{len(htmls)} instances — drag any 3D view to orbit.</p>
{extra}
{''.join(sections)}
"""
    out = os.path.join(results_dir, "index.html")
    with open(out, "w") as f:
        f.write(html)
    log.info("wrote gallery %s", out)
    return out


def plot_loss_distribution(losses, filename="loss_box"):
    """Box plot + mean/std of the step-1 loss list
    (reference evaluate_results.py:107-114 + plotting.py:190-196)."""
    if plt is None:
        return None
    _ensure_dirs()
    losses = np.asarray(losses, np.float64)
    fig, ax = plt.subplots()
    ax.boxplot(losses)
    ax.set_title(f"mean={losses.mean():.4f} std={losses.std():.4f}")
    fig.savefig(f"results/plots/{filename}.png", dpi=120)
    plt.close(fig)
    return float(losses.mean()), float(losses.std())
