"""Plain-PyTorch reference of one view: camera, projection, spherical
harmonics, the covering box, depth order and front-to-back compositing,
with the early stop, forward and backward.

Written from the published semantics of the renderer the benchmark measures
(the Inria rasterizer as ``rasterize.py`` describes it: a 16-pixel block
rounding of the 3-sigma box, halved focal lengths in the EWA Jacobian, a
0.3 low-pass, alpha clamped at 0.99 and skipped below 1/255), not from its
code: it imports nothing but ``torch`` and ``math``.

The design differs from the program's on purpose. There are no tiles and no
pair buffer: each gaussian is expanded to the pixels of its covering box
that its alpha can reach (an ellipse bound, one pixel of guard), the
entries are ordered by (pixel, depth, id), and the transmittance in front
of each entry is an exclusive sum of ``log(1 - alpha)`` along its pixel. The
early stop is per pixel: an entry is composited while the transmittance in
front of it is at least the threshold. The program stops whole tiles, so it
composites at least what this composites, and the two differ by less than
the threshold at every pixel.

Work is cut into depth slices of at most ``entries`` pixel entries. The
forward keeps each slice's incoming transmittance; the backward walks the
slices back to front, recomputes each under autograd and hands the
gradient of its incoming transmittance to the slice in front of it.
Gaussians whose box holds no pixel still above the threshold are skipped.

Every floating tensor is in the ``dtype`` the caller gives: float64 for the
reference, a lower precision for the control.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Tuple

import torch

FRUSTUM_NEAR_Z = 0.2
GAUSSIAN_SPREAD = 3.0
BLOCK = 16
MAX_ALPHA = 0.99
MIN_ALPHA = 1.0 / 255.0
EIGENVALUE_FLOOR = 0.1
COV2D_LOWPASS = 0.3
PERSPECTIVE_EPS = 1e-7
EWA_TAN_CLAMP = 1.3

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005, -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658, 0.3731763325901154,
         -0.4570457994644658, 1.445305721320277, -0.5900435899266435)


class Camera(NamedTuple):
    """A pinhole camera at focal ``0.8 * width`` turned by ``yaw`` about +y
    and moved by ``shift`` along its own x axis (world -> camera:
    ``p_cam = R p + t``)."""

    width: int
    height: int
    rot: torch.Tensor  # [3, 3]
    trans: torch.Tensor  # [3]
    quat: tuple  # (w, x, y, z) as Python floats
    center: torch.Tensor  # [3] camera position in the world
    focal: float
    tan_x: float
    tan_y: float


def camera(width: int, height: int, yaw: float, shift: float, dtype, device) -> Camera:
    focal = 0.8 * width
    w, y = math.cos(yaw / 2.0), math.sin(yaw / 2.0)
    # Unit quaternion (w, 0, y, 0): a turn about +y.
    rot = torch.tensor([[1.0 - 2.0 * y * y, 0.0, 2.0 * y * w],
                        [0.0, 1.0, 0.0],
                        [-2.0 * y * w, 0.0, 1.0 - 2.0 * y * y]], dtype=torch.float64)
    trans = torch.tensor([shift, 0.0, 0.0], dtype=torch.float64)
    center = -(rot.T @ trans)
    to = dict(dtype=dtype, device=device)
    return Camera(width, height, rot.to(**to), trans.to(**to), (w, 0.0, y, 0.0), center.to(**to), focal,
                  width / (2.0 * focal), height / (2.0 * focal))


def depth_key(means: torch.Tensor, cam: Camera, shift_z: float = 0.0) -> torch.Tensor:
    """The sort key: camera-space depth in float32 (below float32: in the
    working precision), the rotation's third row from the quaternion in
    that precision and the depth summed term by term, rounded after each
    operation, as the published rasterizer evaluates it. Two gaussians whose
    depths lie within rounding of each other are then ordered alike on both
    sides, by id."""
    kd = torch.float32 if means.dtype in (torch.float32, torch.float64) else means.dtype
    q = torch.tensor(cam.quat, dtype=kd, device=means.device)
    w, x, y, z = q.unbind(0)
    r20 = 2 * (x * z - y * w)
    r21 = 2 * (y * z + x * w)
    r22 = 1 - 2 * (x * x + y * y)
    m = means.detach().to(kd)
    return m[:, 0] * r20 + m[:, 1] * r21 + m[:, 2] * r22 + torch.tensor(shift_z, dtype=kd, device=means.device)


def sh_color(means: torch.Tensor, sh: torch.Tensor, center: torch.Tensor, degree: int) -> torch.Tensor:
    """View-dependent colour ``[N, 3]``: the real SH basis (band-major) at the
    unit direction from the camera, plus 0.5, clamped to [0, 1]."""
    d = means - center
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    x, y, z = d[:, 0], d[:, 1], d[:, 2]
    basis = [torch.full_like(x, SH_C0)]
    if degree > 0:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree > 1:
        xx, yy, zz = x * x, y * y, z * z
        basis += [SH_C2[0] * x * y, SH_C2[1] * y * z, SH_C2[2] * (2 * zz - xx - yy), SH_C2[3] * x * z,
                  SH_C2[4] * (xx - yy)]
    if degree > 2:
        basis += [SH_C3[0] * y * (3 * xx - yy), SH_C3[1] * x * y * z, SH_C3[2] * y * (4 * zz - xx - yy),
                  SH_C3[3] * z * (2 * zz - 3 * xx - 3 * yy), SH_C3[4] * x * (4 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3 * yy)]
    b = torch.stack(basis, -1)  # [N, B]
    rgb = (b[:, :, None] * sh[:, : b.shape[1], :]).sum(1) + 0.5
    # min/max pass half the gradient where the colour is exactly 0 or 1.
    return torch.minimum(torch.maximum(rgb, torch.zeros_like(rgb)), torch.ones_like(rgb))


class Projected(NamedTuple):
    """Per-gaussian quantities of one view, in depth order of all gaussians."""

    feat: torch.Tensor  # [N, 9] mean x, mean y, conic x, y, xy, opacity, r, g, b (differentiable)
    box: torch.Tensor  # [N, 4] int64 pixel box x0, y0, x1, y1 (half-open) the alpha can reach
    order: torch.Tensor  # [N] gaussians in (depth, id) order, the inactive ones left out


def project(params, cam: Camera, sh_degree: int) -> Projected:
    """Activations, EWA projection, conic and the covering box (the
    reference's two-step rounding: 16-pixel blocks, then pixels)."""
    means, log_scales, quats, opacity_logits, sh = params
    scales = torch.exp(log_scales)
    opacity = torch.sigmoid(opacity_logits)
    q = quats / torch.sqrt((quats * quats).sum(-1, keepdim=True)).clamp(min=1e-12)
    qw, qx, qy, qz = q.unbind(-1)
    rot_g = torch.stack([
        torch.stack([1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw), 2 * (qx * qz + qy * qw)], -1),
        torch.stack([2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qx * qw)], -1),
        torch.stack([2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw), 1 - 2 * (qx * qx + qy * qy)], -1),
    ], -2)  # [N, 3, 3]
    m = rot_g * scales[:, None, :]
    cov3 = (m[:, :, None, :] * m[:, None, :, :]).sum(-1)  # M M^T

    p = (cam.rot[None, :, :] * means[:, None, :]).sum(-1) + cam.trans  # [N, 3] camera space
    cx, cy, depth = p.unbind(-1)
    culled = depth < FRUSTUM_NEAR_Z
    zero = torch.zeros_like(cx)
    # Perspective: clip x = x / tan(fov_x / 2), clip w = z (culled: zeroed).
    clip_x = torch.where(culled, zero, cx / cam.tan_x)
    clip_y = torch.where(culled, zero, cy / cam.tan_y)
    clip_w = torch.where(culled, zero, depth)
    mean_x = ((clip_x / (clip_w + PERSPECTIVE_EPS) + 1.0) * cam.width - 1.0) / 2.0
    mean_y = ((clip_y / (clip_w + PERSPECTIVE_EPS) + 1.0) * cam.height - 1.0) / 2.0

    # EWA: J (with the reference's halved focal lengths) times the rotation.
    f = cam.focal / 2.0
    lim_x, lim_y = EWA_TAN_CLAMP * cam.tan_x, EWA_TAN_CLAMP * cam.tan_y
    tx = torch.clamp(cx / depth, -lim_x, lim_x) * depth
    ty = torch.clamp(cy / depth, -lim_y, lim_y) * depth
    j = torch.stack([
        torch.stack([f / depth, zero, -f * tx / (depth * depth)], -1),
        torch.stack([zero, f / depth, -f * ty / (depth * depth)], -1),
    ], -2)  # [N, 2, 3]
    t = (j[:, :, :, None] * cam.rot[None, None, :, :]).sum(2)  # [N, 2, 3] = J R
    tc = (t[:, :, :, None] * cov3[:, None, :, :]).sum(2)  # [N, 2, 3] = T Cov
    cov2 = (tc[:, :, None, :] * t[:, None, :, :]).sum(-1)  # [N, 2, 2] = T Cov T^T
    a = torch.where(culled, zero, cov2[:, 0, 0] + COV2D_LOWPASS)
    b = torch.where(culled, zero, cov2[:, 0, 1])
    c = torch.where(culled, zero, cov2[:, 1, 1] + COV2D_LOWPASS)
    det = a * c - b * b
    inv = torch.where(det == 0, zero, 1.0 / torch.where(det == 0, torch.ones_like(det), det))
    conic = torch.stack([c * inv, a * inv, -b * inv], -1)

    rgb = sh_color(means, sh, cam.center, sh_degree)
    feat = torch.cat([mean_x[:, None], mean_y[:, None], conic, opacity[:, None], rgb], -1)

    with torch.no_grad():
        half = (a + c) / 2.0
        lam = half + torch.sqrt(torch.clamp(half * half - det, min=EIGENVALUE_FLOOR))
        spread = torch.ceil(GAUSSIAN_SPREAD * torch.sqrt(lam))

        def px(v, limit):
            blocks = torch.floor(torch.clamp(v / BLOCK, 0, limit - 1)).long()
            return torch.clamp(blocks * BLOCK, 0, limit - 1)

        x0, x1 = px(mean_x - spread, cam.width), px(mean_x + spread + BLOCK - 1, cam.width)
        y0, y1 = px(mean_y - spread, cam.height), px(mean_y + spread + BLOCK - 1, cam.height)
        active = ((x1 - x0) * (y1 - y0) > 0) & (conic != 0).all(-1)
        # Where alpha can pass 1/255: opacity * exp(-q/2) > 1/255 bounds
        # |dx| by sqrt(2 ln(255 opacity) cov_xx), and |dy| alike.
        gate = torch.log(torch.clamp(opacity * 255.0, min=1e-30))
        live = gate > 0
        gate = torch.clamp(gate, min=0.0)
        rx = torch.sqrt(2.0 * gate * torch.clamp(a, min=0.0)) + 1.0
        ry = torch.sqrt(2.0 * gate * torch.clamp(c, min=0.0)) + 1.0
        big = float(cam.width + cam.height)
        bx0 = torch.maximum(x0, torch.clamp(torch.ceil(mean_x - rx), -1.0, big).long())
        by0 = torch.maximum(y0, torch.clamp(torch.ceil(mean_y - ry), -1.0, big).long())
        bx1 = torch.minimum(x1, torch.clamp(torch.floor(mean_x + rx), -1.0, big).long() + 1)
        by1 = torch.minimum(y1, torch.clamp(torch.floor(mean_y + ry), -1.0, big).long() + 1)
        active &= live & (bx1 > bx0) & (by1 > by0)
        box = torch.stack([bx0, by0, bx1, by1], -1)
        order = torch.sort(depth_key(means, cam, float(cam.trans[2])), stable=True).indices
        order = order[active[order]]
    return Projected(feat, box, order)


class Counts(NamedTuple):
    """Work of one view's compositing as this reference walks it: pixel
    entries inside the boxes up to each pixel's early stop (``in_box``),
    those among them whose alpha passes the gate (``passed``), and the
    gaussians with at least one such entry (``gaussians``)."""

    in_box: int
    passed: int
    gaussians: int


def _entries(box: torch.Tensor, width: int):
    """Every pixel of each box, gaussian by gaussian: (owner row [E], pixel
    index [E])."""
    w = box[:, 2] - box[:, 0]
    h = box[:, 3] - box[:, 1]
    n = w * h
    owner = torch.repeat_interleave(torch.arange(box.shape[0], device=box.device), n)
    local = torch.arange(owner.shape[0], device=box.device) - (torch.cumsum(n, 0) - n)[owner]
    x = box[owner, 0] + local % w[owner]
    y = box[owner, 1] + local // w[owner]
    return owner, y * width + x


def _exclusive_segment_sum(v: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """For entries sorted by ``key``, the sum of ``v`` over the earlier
    entries of the same key: a doubling scan, so that every partial sum
    stays within one key's entries (well conditioned in any precision)."""
    n = v.shape[0]
    if n == 0:
        return v
    _, runs = torch.unique_consecutive(key, return_counts=True)
    longest = int(runs.max())
    incl = v
    d = 1
    while d < longest:
        same = torch.zeros(n, dtype=torch.bool, device=v.device)
        same[d:] = key[d:] == key[:-d]
        shifted = torch.cat([torch.zeros(d, dtype=v.dtype, device=v.device), incl[:-d]])
        incl = incl + torch.where(same, shifted, torch.zeros_like(shifted))
        d *= 2
    return incl - v


def _slice(feat: torch.Tensor, ids: torch.Tensor, box: torch.Tensor, t_in: torch.Tensor, width: int,
           stop: float):
    """Composite one depth slice (gaussians ``ids`` in depth order) onto
    the transmittance ``t_in [P]``. Returns (colour added [P, 3], transmittance
    out [P], in-box entries composited, of which passed, gaussians with
    one)."""
    owner, pix = _entries(box[ids], width)
    if stop > 0.0:
        keep = t_in[pix] >= stop
        owner, pix = owner[keep], pix[keep]
    # (pixel, depth, id) order: entries come gaussian by gaussian in depth
    # order, so a stable sort by pixel keeps depth order inside a pixel.
    perm = torch.sort(pix, stable=True).indices
    owner, pix = owner[perm], pix[perm]
    f = feat[ids][owner]
    dx = f[:, 0] - pix.remainder(width).to(f.dtype)
    dy = f[:, 1] - torch.div(pix, width, rounding_mode="floor").to(f.dtype)
    density = -0.5 * (f[:, 2] * dx * dx + f[:, 3] * dy * dy) - f[:, 4] * dx * dy
    alpha = torch.clamp(f[:, 5] * torch.exp(density), max=MAX_ALPHA)
    valid = (alpha > MIN_ALPHA) & (density <= 0)
    alpha = torch.where(valid, alpha, torch.zeros_like(alpha))
    log_t = torch.log1p(-alpha)
    t_front = t_in[pix] * torch.exp(_exclusive_segment_sum(log_t, pix))
    on = t_front.detach() >= stop if stop > 0.0 else torch.ones_like(valid)
    weight = torch.where(on, alpha * t_front, torch.zeros_like(alpha))
    color = torch.zeros((t_in.shape[0], 3), dtype=f.dtype, device=f.device).index_add(
        0, pix, weight[:, None] * f[:, 6:9])
    log_sum = torch.zeros_like(t_in).index_add(0, pix, torch.where(on, log_t, torch.zeros_like(log_t)))
    t_out = t_in * torch.exp(log_sum)
    with torch.no_grad():
        used = torch.zeros(ids.shape[0], dtype=torch.bool, device=ids.device)
        used[owner[on]] = True
        counts = (int(on.sum()), int((on & valid).sum()), int(used.sum()))
    return color, t_out, counts


def _alive_boxes(t: torch.Tensor, box: torch.Tensor, width: int, height: int, stop: float) -> torch.Tensor:
    """Which boxes still hold a pixel with transmittance at least ``stop``
    (a summed-area table of the live pixels)."""
    live = (t >= stop).reshape(height, width).long()
    table = torch.nn.functional.pad(live.cumsum(0).cumsum(1), (1, 0, 1, 0)).reshape(-1)
    w = width + 1
    x0, y0, x1, y1 = box.unbind(-1)
    hits = table[y1 * w + x1] - table[y0 * w + x1] - table[y1 * w + x0] + table[y0 * w + x0]
    return hits > 0


def _plan(proj: Projected, width: int, height: int, stop: float, entries: int, feat: torch.Tensor):
    """The forward walk: slices of at most ``entries`` pixel entries, front
    to back. Returns (colour [P, 3], transmittance [P], slices: list of
    (ids, incoming transmittance), Counts)."""
    npix = width * height
    color = torch.zeros((npix, 3), dtype=feat.dtype, device=feat.device)
    t = torch.ones(npix, dtype=feat.dtype, device=feat.device)
    order, box = proj.order, proj.box
    area = (box[:, 2] - box[:, 0]) * (box[:, 3] - box[:, 1])
    slices: List[Tuple[torch.Tensor, torch.Tensor]] = []
    total = [0, 0, 0]
    g0 = 0
    while g0 < order.shape[0]:
        rest = order[g0:]
        size = area[rest]
        if stop > 0.0:
            size = torch.where(_alive_boxes(t, box[rest], width, height, stop), size, torch.zeros_like(size))
        cum = torch.cumsum(size, 0)
        take = max(int(torch.searchsorted(cum, torch.tensor([entries], device=cum.device), right=True)), 1)
        ids = rest[:take][size[:take] > 0]
        g0 += take
        if ids.numel() == 0:
            continue
        with torch.no_grad():
            added, t_out, c = _slice(feat, ids, box, t, width, stop)
        slices.append((ids, t))
        color = color + added
        t = t_out
        total = [u + v for u, v in zip(total, c)]
        if stop > 0.0 and not bool((t >= stop).any()):
            break
    return color, t, slices, Counts(*total)


class View(NamedTuple):
    image: torch.Tensor  # [H, W, 3]
    trans: torch.Tensor  # [H, W]
    counts: Counts


def render(params, cam: Camera, sh_degree: int, stop: float, entries: int = 1 << 25) -> View:
    """Forward only: the frame and its transmittance."""
    with torch.no_grad():
        proj = project(params, cam, sh_degree)
        color, t, _, counts = _plan(proj, cam.width, cam.height, stop, entries, proj.feat)
    return View(color.reshape(cam.height, cam.width, 3), t.reshape(cam.height, cam.width), counts)


def render_backward(params, cam: Camera, sh_degree: int, stop: float, image_grad_fn,
                    entries: int = 1 << 25):
    """Forward, then the gradients of ``image_grad_fn(image)`` (a scalar
    loss of the ``[H, W, 3]`` frame) to the raw parameters. Returns
    (View, loss, gradients in the order of ``params``)."""
    leaves = [p.detach().requires_grad_(True) for p in params]
    proj = project(leaves, cam, sh_degree)
    feat = proj.feat.detach().requires_grad_(True)
    with torch.no_grad():
        color, t, slices, counts = _plan(proj, cam.width, cam.height, stop, entries, feat)
    image = color.reshape(cam.height, cam.width, 3).detach().requires_grad_(True)
    loss = image_grad_fn(image)
    (g_image,) = torch.autograd.grad(loss, [image])
    g_color = g_image.reshape(-1, 3)
    g_t: Optional[torch.Tensor] = torch.zeros_like(t)
    for ids, t_in in reversed(slices):
        t_leaf = t_in.detach().requires_grad_(True)
        added, t_out, _ = _slice(feat, ids, proj.box, t_leaf, cam.width, stop)
        torch.autograd.backward([added, t_out], [g_color, g_t])
        g_t = t_leaf.grad
    grads = torch.autograd.grad(proj.feat, leaves, feat.grad if feat.grad is not None else torch.zeros_like(feat),
                                allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
    view = View(image.detach(), t.reshape(cam.height, cam.width), counts)
    return view, loss.detach(), grads
