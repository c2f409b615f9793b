"""The plain reference of the MRC decomposition, in PyTorch and NumPy.

Frozen copies of the port's plain versions of its kernels (the CPU
oracles of ``csrc/*.cu``; ``ops/window.py``, ``ops/sauvola.py``,
``ops/sigma.py``, ``ops/sigma_np.py``, the plain blur of
``ops/threshold_cuda.py``, the line loop of ``ops/lines_cuda.py``, the
paste of ``ops/paste_cuda.py``, ``ops/optimise.py``,
``ops/resize.py``) and of the host logic around them (the line filter of
``mrc/hocr_prep.py``, the blur taps and ``select_lines`` of
``mrc/decompose.py``), held here so that a change to the port never
moves the yardstick.  Nothing here imports the port.

``ftype`` is the precision of every float32 stage (noise estimate, blur
taps and blur, the Sauvola test, the layer resize, a float denoise) and
``ftype64`` that of the float64 line-sigma estimate: the control passes
``torch.bfloat16`` and ``np.float32``.

The mask's last stage is the denoise that the configuration's
``denoise_mask`` names, found by file name: ``denoise_<mode>.py`` beside
this file, whose ``denoise(mask, ftype=torch.float32)`` returns the
denoised bool (B, H, W) mask on the mask's device.
"""

import importlib
import math

import numpy as np
import torch

RADIUS_BUCKETS = (4, 8, 16, 48)
GLOBAL_K = 0.34
LINE_K = 0.1
SAUVOLA_R = 128.0
FG_N = 3
BG_N = 10

_DB2_HI = [-0.48296291314469025, 0.836516303737469,
           -0.22414386804185735, -0.12940952255092145]
_MAD_DENOM = 0.6744897501960817


def sauvola_window(dpi):
    """dpi/4 rounded up to odd; 51 when the dpi is unknown."""
    if dpi is None:
        return 51
    w = int(dpi / 4)
    return w + 1 if w % 2 == 0 else w


def gray_601(rgb):
    """PIL's ``convert('L')``: (R*19595 + G*38470 + B*7471 + 2^15) >> 16."""
    x = rgb.to(torch.int32)
    return ((x[..., 0] * 19595 + x[..., 1] * 38470 + x[..., 2] * 7471
             + 32768) >> 16).to(torch.uint8)


# ---------------------------------------------------------- window sums

def sliding_sum(x, lo, hi, dim):
    """out[i] = sum(x[max(i+lo, 0) : min(i+hi, n)]) along dim (exact for
    integers)."""
    dim = dim % x.dim()
    n = x.shape[dim]
    cs = torch.cumsum(x, dim=dim)
    zshape = list(cs.shape)
    zshape[dim] = 1
    cs = torch.cat([torch.zeros(zshape, dtype=cs.dtype, device=cs.device),
                    cs], dim=dim)
    i = torch.arange(n, device=x.device)
    return (cs.index_select(dim, (i + hi).clamp(0, n))
            - cs.index_select(dim, (i + lo).clamp(0, n)))


def box_sum_2d(x, rows, cols):
    return sliding_sum(sliding_sum(x, rows[0], rows[1], -2),
                       cols[0], cols[1], -1)


def symmetric_index(n, lo, hi, device):
    """Indices of ``np.pad(..., (lo, hi), mode='symmetric')`` on n."""
    p = torch.arange(-lo, n + hi, device=device) % (2 * n)
    return torch.where(p < n, p, 2 * n - 1 - p)


# -------------------------------------------------------------- Sauvola

def sauvola_mask(img, window, k, ftype=torch.float32, R=SAUVOLA_R):
    """Sauvola ink mask (True = ink) of uint8 (..., H, W): clamped window
    sums, integer mean and E[x^2] by floor division, the squared-form
    test in ``ftype``."""
    o, u = (window + 1) // 2, window // 2
    rows, cols = (-o + 1, u + 1), (-o + 1, u + 1)
    x = img.to(torch.int64)
    s = box_sum_2d(x, rows, cols)
    s2 = box_sum_2d(x * x, rows, cols)
    dev = img.device

    def count(n):
        i = torch.arange(n, device=dev)
        return (i + rows[1]).clamp(max=n) - (i + rows[0]).clamp(min=0)
    cnt = count(img.shape[-2])[:, None] * count(img.shape[-1])[None, :]
    mean_i = s // cnt
    var_i = s2 // cnt - mean_i * mean_i
    k32, r32 = np.float32(k), np.float32(R)
    km1 = torch.tensor(float(np.float32(k32 - np.float32(1.0))), dtype=ftype,
                       device=dev)
    k2 = torch.tensor(float(np.float32(k32 * k32 / r32 / r32)), dtype=ftype,
                      device=dev)
    mean = mean_i.to(ftype)
    t = img.to(ftype) + mean * km1
    rhs = mean * mean * k2 * var_i.to(ftype)
    if k >= 0:
        return (t <= 0.0) | (t * t <= rhs)
    return (t <= 0.0) & (t * t >= rhs)


# ------------------------------------------------- noise and blur taps

def _dwt1d(x, dim):
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    xp = x[..., symmetric_index(n, 2, 3, x.device)]
    nout = (n + 3) // 2
    out = None
    for j, c in enumerate(_DB2_HI[::-1]):
        term = float(np.float32(c)) * xp[..., j:j + 2 * nout - 1:2]
        out = term if out is None else out + term
    return out.movedim(-1, dim)


def estimate_noise(img, ftype=torch.float32):
    """Wavelet-MAD sigma of the middle half of each page of (B, H, W):
    the db2 diagonal band, exact zeros dropped, median(|dd|) / 0.6745."""
    h, w = img.shape[-2], img.shape[-1]
    hs, he = int(h / 2 - h / 4), int(h / 2 + h / 4)
    ws, we = int(w / 2 - w / 4), int(w / 2 + w / 4)
    if he == 0 or we == 0:
        hs, he, ws, we = 0, h, 0, w
    crop = img[..., hs:he, ws:we].to(ftype)
    dd = _dwt1d(_dwt1d(crop, -2), -1)
    flat = dd.reshape(dd.shape[0], -1).abs()
    keep = flat > 0
    n = keep.sum(dim=1)
    srt = torch.sort(torch.where(keep, flat, torch.full_like(flat, math.inf)),
                     dim=1).values
    lo = srt.gather(1, ((n - 1) // 2).clamp(min=0)[:, None])[:, 0]
    hi = srt.gather(1, (n // 2).clamp(min=0)[:, None])[:, 0]
    med = torch.where(n > 0, 0.5 * (lo + hi), torch.zeros_like(lo))
    return med / torch.tensor(_MAD_DENOM, dtype=ftype, device=med.device)


def blur_taps(sigma_est, ftype=torch.float32):
    """Taps (B, 2r+1) for a batch's noise estimates, r the smallest
    bucket covering the batch's largest need int(4*0.1*s + 0.5): each
    page's scipy-sampled gaussian (identity when s <= 1)."""
    sig = sigma_est.detach().cpu().to(ftype)
    need = int(np.floor(4.0 * 0.1 * sig.float().numpy().astype(np.float32)
                        .max() + 0.5))
    radius = next((r for r in RADIUS_BUCKETS if need <= r), RADIUS_BUCKETS[-1])
    sigma = sig * 0.1
    idx = torch.arange(-radius, radius + 1, dtype=ftype)
    rad = torch.floor(4.0 * sigma + 0.5)[:, None]
    sig2 = sigma.clamp(min=1e-6)[:, None] ** 2
    wts = torch.exp(-0.5 * idx[None, :] ** 2 / sig2)
    wts = torch.where(idx[None, :].abs() <= rad, wts, 0.0)
    wts = wts / wts.sum(dim=1, keepdim=True)
    ident = (idx == 0).to(ftype)
    return torch.where((sig > 1.0)[:, None], wts, ident[None, :])


def separable_blur(img, taps):
    """uint8 (B, H, W) blurred with per-page taps (B, 2r+1) in taps'
    dtype, vertical then horizontal, symmetric borders, truncated to
    uint8."""
    r = (taps.shape[1] - 1) // 2
    b, h, w = img.shape
    x = img.to(taps.dtype)
    xp = x[:, symmetric_index(h, r, r, x.device)]
    v = torch.zeros_like(xp[:, :h])
    for t in range(taps.shape[1]):
        v = v + taps[:, t, None, None] * xp[:, t:t + h]
    vp = v[:, :, symmetric_index(w, r, r, v.device)]
    o = torch.zeros_like(vp[:, :, :w])
    for t in range(taps.shape[1]):
        o = o + taps[:, t, None, None] * vp[:, :, t:t + w]
    return o.to(torch.int32).clamp(0, 255).to(torch.uint8)


# ------------------------------------------------------------ hOCR lines

def line_boxes(boxes, w, h):
    """The line filter: (t, b, l, r) of the boxes (x0, y0, x1, y1) that
    are neither empty nor outside the page, in document order (every
    benchmark line has text and confidence 95)."""
    out = []
    for x0, y0, x1, y1 in boxes:
        left, top, right, bottom = int(x0), int(y0), int(x1), int(y1)
        if left >= right or top >= bottom:
            continue
        if left < 0 or right > w or top < 0 or bottom > h:
            continue
        out.append((top, bottom, left, right))
    return out


def _dwt1d_np(a, axis, dtype):
    k = np.asarray(_DB2_HI, dtype)[::-1]
    a = np.moveaxis(np.asarray(a, dtype), axis, -1)
    n = a.shape[-1]
    ap = np.pad(a, [(0, 0)] * (a.ndim - 1) + [(2, 3)], mode='symmetric')
    nout = (n + 3) // 2
    out = np.zeros(a.shape[:-1] + (nout,), dtype)
    for j in range(4):
        out += k[j] * ap[..., j:j + 2 * nout:2][..., :nout]
    return np.moveaxis(out, -1, axis)


def estimate_sigma_np(img, dtype=np.float64):
    """skimage ``estimate_sigma`` (db2 diagonal band, zeros dropped)."""
    dd = _dwt1d_np(_dwt1d_np(img, -2, dtype), -1, dtype)
    flat = np.abs(dd).ravel()
    nz = flat[flat > 0]
    if nz.size == 0:
        return 0.0
    return float(np.median(nz) / dtype(_MAD_DENOM))


def select_line(m_t, m_i, ftype64):
    """0 (none), 1 (the crop's mask) or 2 (the inverse crop's): the
    reference's polarity heuristic for one line."""
    size = m_t.numel()
    ratio = int(m_t.sum()) / size
    inv_ratio = int(m_i.sum()) / size
    if not (ratio < 0.3 or inv_ratio < 0.3):
        return 0
    if inv_ratio > 0.2 and ratio < 0.2:
        return 1
    ct = m_t.cpu().numpy().astype(ftype64)
    ci = m_i.cpu().numpy().astype(ftype64)
    ratio_sigma = estimate_sigma_np(ct, ftype64)
    inv_ratio_sigma = estimate_sigma_np(ci, ftype64)
    if inv_ratio < 0.3 and inv_ratio < ratio and (
            inv_ratio_sigma < ratio_sigma
            or (ratio_sigma < 0.1 and inv_ratio_sigma < 0.1)):
        return 2
    if ratio < 0.2:
        return 1
    return 0


# ---------------------------------------------------------- layer fills

def optimise(mask, img, n):
    """Radiate fill: mask pixels pass img through; every other pixel is
    (FIR + IIR sum) // (FIR + IIR count), FIR over mask pixels of the
    clamped window rows [y-n, y+n) x cols [x-n, x+n), IIR over produced
    output of rows [y-n, y) x cols [x-n, x)."""
    gray = img.dim() == 3
    if gray:
        img = img[..., None]
    b, h, w, c = img.shape
    dev = img.device
    mi = mask.to(torch.int64)[:, None]
    xi = img.to(torch.int64).permute(0, 3, 1, 2)
    fir_val = box_sum_2d(xi * mi, (-n, n), (-n, n))
    fir_cnt = box_sum_2d(mi, (-n, n), (-n, n))
    cols = torch.arange(w, device=dev)
    xs_idx = (cols - n).clamp(min=0)
    iir_w = cols - xs_idx
    out = torch.empty_like(xi)
    colsum = torch.zeros((b, c, w), dtype=torch.int64, device=dev)
    zero = torch.zeros((b, c, 1), dtype=torch.int64, device=dev)
    for y in range(h):
        pref = torch.cat([zero, torch.cumsum(colsum, dim=-1)], dim=-1)
        iir_sum = pref[..., :w] - pref[..., xs_idx]
        cnt = fir_cnt[:, :, y] + min(y, n) * iir_w
        val = fir_val[:, :, y] + iir_sum
        filled = torch.where(cnt > 0, val // cnt.clamp(min=1), 0)
        row = torch.where(mask[:, None, y], xi[:, :, y], filled)
        out[:, :, y] = row
        colsum += row
        if y >= n:
            colsum -= out[:, :, y - n]
    out = out.permute(0, 2, 3, 1).to(torch.uint8)
    return out[..., 0] if gray else out


# -------------------------------------------------------------- resize

def _bicubic(x, a=-0.5):
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1.0
    if x < 2.0:
        return (((x - 5.0) * x + 8.0) * x - 4.0) * a
    return 0.0


def resize_matrix(in_size, out_size):
    """(out, in) float32 PIL bicubic resampling matrix."""
    scale = in_size / out_size
    fscale = max(scale, 1.0)
    sup = 2.0 * fscale
    mat = np.zeros((out_size, in_size), np.float32)
    for i in range(out_size):
        center = (i + 0.5) * scale
        jmin = max(int(center - sup + 0.5), 0)
        jmax = min(int(center + sup + 0.5), in_size)
        wt = np.array([_bicubic((j + 0.5 - center) / fscale)
                       for j in range(jmin, jmax)], np.float64)
        s = wt.sum()
        if s != 0:
            wt /= s
        mat[i, jmin:jmax] = wt
    return mat


def thumbnail_size(w, h, box_w, box_h):
    """PIL ``Image.thumbnail``'s aspect fit; None when the image fits."""
    x, y = math.floor(box_w), math.floor(box_h)
    if x >= w and y >= h:
        return None

    def round_aspect(number, key):
        return max(min(math.floor(number), math.ceil(number), key=key), 1)

    aspect = w / h
    if x / y >= aspect:
        x = round_aspect(y * aspect, key=lambda v: abs(aspect - v / y))
    else:
        y = round_aspect(x / aspect,
                         key=lambda v: 0 if v == 0 else abs(aspect - x / v))
    return x, y


def downsample(layer, factor, ftype=torch.float32):
    """A (B, H, W[, C]) uint8 layer thumbnailed into (W//f, H//f) with PIL
    bicubic weights, two matrix products in ``ftype`` (TF32 off) with
    PIL's uint8 rounding between them."""
    chan = layer.dim() == 4
    h, w = layer.shape[1], layer.shape[2]
    bw, bh = int(w / factor), int(h / factor)
    if bw <= 0 or bh <= 0:
        return layer
    tgt = thumbnail_size(w, h, bw, bh)
    if tgt is None:
        return layer
    tw, th = tgt
    ah = torch.from_numpy(resize_matrix(h, th)).to(layer.device, ftype)
    aw = torch.from_numpy(resize_matrix(w, tw)).to(layer.device, ftype)
    x = layer.to(ftype)

    def quant(a):
        return torch.floor(a + 0.5).clamp(0, 255)

    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        if chan:
            y = quant(torch.einsum('pw,...hwc->...hpc', aw, x))
            y = quant(torch.einsum('oh,...hpc->...opc', ah, y))
        else:
            y = quant(torch.einsum('pw,...hw->...hp', aw, x))
            y = quant(torch.einsum('oh,...hp->...op', ah, y))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
    return y.to(torch.uint8)


# ------------------------------------------------------- decomposition

def batches(modes, shapes, batch_pages=8):
    """The recode's page batches: consecutive pages of one shape and mode,
    at most ``batch_pages`` (half the book, rounded up, for a book of
    4..batch_pages pages)."""
    n = len(modes)
    if 4 <= n <= batch_pages:
        batch_pages = (n + 1) // 2
    out, cur, key = [], [], None
    for i in range(n):
        k = (shapes[i], modes[i])
        if cur and (k != key or len(cur) >= batch_pages):
            out.append(cur)
            cur = []
        key = k
        cur.append(i)
    if cur:
        out.append(cur)
    return out


def denoise_mode(recode_flags):
    """The ``--denoise-mask`` mode a configuration's flags run: recode()'s
    ``fast`` where they name none, ``none`` for None."""
    mode = recode_flags.get('denoise_mask', 'fast')
    return 'none' if mode is None else mode


def denoiser(mode):
    """``denoise`` of ``denoise_<mode>.py`` beside this file; ValueError,
    naming the mode and the file, where there is no such file."""
    name = '%s.denoise_%s' % (__package__, mode)
    try:
        return importlib.import_module(name).denoise
    except ModuleNotFoundError as e:
        if e.name is None or not name.startswith(e.name):
            raise      # a module that the mode's file imports is missing
        raise ValueError('denoise_mask %r has no reference: no '
                         'portbench/reference/denoise_%s.py'
                         % (mode, mode)) from None


def masks(pages, page_boxes, dpi, ftype=torch.float32, ftype64=np.float64,
          denoise_mask='fast'):
    """The mask of each page of one batch: uint8 (B, H, W) gray or
    (B, H, W, 3) RGB on its device, and each page's line boxes
    (x0, y0, x1, y1).  The global mask (blur + Sauvola, k=0.34), then
    each line's selected crop (Sauvola k=0.1 of the crop or of its
    inverse) pasted in document order, the last line winning an overlap,
    OR-ed with the global mask, then denoised in mode ``denoise_mask``
    (``denoiser``).  Returns bool (B, H, W)."""
    denoise = denoiser(denoise_mask)
    gray = gray_601(pages) if pages.dim() == 4 else pages
    b, h, w = gray.shape
    window = sauvola_window(dpi)
    taps = blur_taps(estimate_noise(gray, ftype), ftype)
    mask = sauvola_mask(separable_blur(gray, taps.to(gray.device)), window,
                        GLOBAL_K, ftype)
    for p in range(b):
        pasted = torch.zeros_like(mask[p])
        for t, bo, l, r in line_boxes(page_boxes[p], w, h):
            crop = gray[p, t:bo, l:r]
            m_t = sauvola_mask(crop, window, LINE_K, ftype)
            m_i = sauvola_mask(255 - crop, window, LINE_K, ftype)
            sel = select_line(m_t, m_i, ftype64)
            if sel:
                pasted[t:bo, l:r] = m_t if sel == 1 else m_i
        mask[p] |= pasted
    return denoise(mask, ftype=ftype)


def layers(mask, pages, bg_downsample=None, fg_downsample=None,
           ftype=torch.float32):
    """(fg, bg) uint8 layers of one batch: the n=3 fill on the mask and
    the n=10 fill on its inverse, each thumbnailed by its factor."""
    fg = optimise(mask, pages, FG_N)
    if fg_downsample:
        fg = downsample(fg, fg_downsample, ftype)
    bg = optimise(~mask, pages, BG_N)
    if bg_downsample:
        bg = downsample(bg, bg_downsample, ftype)
    return fg, bg
