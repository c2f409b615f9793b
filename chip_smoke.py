#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (archive_pdf_tools_tpu_torch) on
one NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, in order; any failure ends the run with a non-zero exit:

1. Device and build: the card's name and power limit, and the nvcc
   builds of the six kernels (``archive_pdf_tools_tpu_torch/csrc``) and
   of the eight ablation builds of the blur + Sauvola kernel (K6), all
   started together with the g++ builds of the host JPEG2000 Tier-1 and
   JBIG2 coders (``native/jp2t1.cpp``, ``native/jbig2.cpp``, into the
   port's ``build/``).
2. Kernel vs plain version, on the card, at the main path's shapes (a
   batch of 8 gray 400-DPI pages, 3300x2550, and their ~60 hOCR lines a
   page; RGB for the fill; the fills' gray and RGB layers for the
   JPEG2000 transform, 5 levels): each kernel must equal its plain
   PyTorch version bit for bit.  The line paste runs with the real
   selection and with an adversarial one over overlapping boxes.  Times
   are medians of CUDA-event-timed runs after a warm-up, each printed
   beside its bound: the bytes the function must move (each input read
   once, each output written once) at the card's 3.35 TB/s, or its
   operations at the scalar peak, the larger.  Then (2b) the
   same check at small and ragged shapes: one-row, tall (> 512 rows) and
   narrow lines, pages with no lines, no selected line, the global
   threshold at windows 183 and 201 (sums of squares past 2^31), the
   transform at odd sizes, one-page batches and levels capped by the
   page size, and the fill and the despeckle at their edges (widths off
   the warp and word grain and below 2n+1 columns, fewer than 5 rows,
   masks all set and all clear, noise at 30/50/70% ink, n=1, the fill's
   rows around its one-CTA and cluster widths and one column past them),
   lines of every height from 1 to 60 rows and of 290-300 rows, pasted
   over overlapping boxes whose lines are not sorted by page, and every
   kernel at its widest input: the fill (n=3 and n=10, gray and RGB),
   the despeckle, the global threshold and the transform on pages of
   120,000 columns (PDF's 200-inch page at 600 DPI; the fill and the
   despeckle run as a wavefront of column strips past one CTA or
   cluster), the despeckle also at the widest page one CTA takes and
   one column more, the line threshold and the paste on a line of
   120,000 columns and on one just past a tile.  (2c) each ablation
   build of K3 against its plain version at the same batch, then one
   run of the ablation tool
   (``archive_pdf_tools_tpu_torch/tools/threshold_ablate.py``) at batch 2.
   (2d) the three off-path ops, torch ops on the card, against their CPU
   form, with their CUDA-event times and peak device memory: the gray
   conversion of ``--grayscale-pdf`` on the RGB page (bit-equal), the
   one-pass despeckle of ``--approx-denoise`` on phase 2's batch of
   Sauvola masks (bit-equal), and the split-Bregman TV denoise of
   ``--denoise-mask bregman`` on one page's mask (the > 0.4 masks agree
   at >= 0.9999; the CPU form runs on a thread from phase 2 on), timed
   at batch 8 too.  (2e) the fused step (``mrc/step.py:mrc_full_step``)
   on phase 2's batch with the selector the main path picks: its mask,
   fg, bg and line counts equal ``decompose_masks`` +
   ``decompose_layers``' bit for bit, each of K1-K5 launched once (K1
   twice), its CUDA-event time printed beside the sum of K1-K5's phase 2
   times; then the step split over two shards on the one card
   (``parallel/sharded.py:sharded_mrc_step`` over ``[cuda:0, cuda:0]``)
   and over the visible cards where there are several, equal bit for
   bit.
3. End to end, through the recode_pdf_torch CLI: a 16-page 400-DPI book
   with hOCR lines (15 gray pages, 1 RGB), once with default flags, once
   with ``--bg-downsample 3`` and once with the in-tree JPEG2000 encoder
   (``-J tpu``, one HQ page); then 8 of its pages with hOCR that holds
   no words.  Each output must pass the PDF/A validator and each kernel
   of the path must have launched in that run; with ``-J tpu`` every JPX
   stream must also pass the strict JPEG2000 validator, decode with
   Pillow, and a sampled code block must decode with the from-spec
   Tier-1 decoder and re-encode to the same bytes.  A small worded book
   recoded on the card must also equal, byte for byte, the same book
   recoded with the plain versions on the CPU, with Pillow's JPEG2000
   and with ``-J tpu`` (3b).  (3c)
   ``--from-pdf`` with ``-T`` on a PDF that Pillow writes from the
   book's first 8 pages (one JPEG a page); ``--from-pdf`` without ``-T``
   on the small book's own MRC PDF (two images and a text layer a page);
   the small book with ``--scandata-file``.  (3d) every recode option off
   the main path on the small book, card against CPU, equal
   bytes (bregman: masks at >= 0.9999; ``--profile``: the bytes of the
   run without it); then three full-size runs: pages 8-15 with ``-J tpu
   --grayscale-pdf --jbig2-symbol-coding auto --profile DIR``, whose
   Chrome trace must name K1-K5 and B7 and gives the device's busy share
   of the traced span; pages 0-7 with ``--bw-pdf --denoise-mask
   bregman`` (no fill and no despeckle launch); and compress-pdf-images
   with hOCR on a two-page JPEG PDF of the book, whose masks must equal
   a ``--device cpu`` run's bit for bit (that run on the thread too).
   (3e) a 3-page gray book recoded in batches of 2 split over
   ``[cuda:0, cuda:0]`` (put in place of the several cards
   ``parallel/mesh.default_devices`` would give; the first batch split
   over two shards, K3 launched three times) gives the one-device bytes, with Pillow's JPEG2000 and with
   ``-J tpu``; the debug tools threshold_image (K3 with identity taps and
   K2), partial_blur (K1) and compress (K1 twice) on one full-size RGB
   page give the bytes of their ``--device cpu`` runs; mrcview,
   pdfimagesmrc, pdf-to-imagestack_torch and pdfrenderer_torch run on
   phase 3b's small book (its card PDF and hOCR) and exit 0.  (3f)
   epub-to-pdf_torch, which does no device work, on the cases of
   ``tests/test_torch_epub.py`` (a reflowable book with styles, lists,
   a table, images, a nav TOC and links; comments, processing
   instructions and entities in styled runs and list items; chapters
   that take the HTML parser; a fixed-layout book; an XPS with an
   obfuscated font): each PDF must carry the sha256 pinned there for the
   JAX converter's output, with or without matplotlib and fontTools as
   this machine has them; the port's own tree builder stands in for
   lxml.  (3g) hOCR that is not well-formed, read with no lxml: the rows
   of ROADMAP C16 and 200 seeded mutated documents
   (``tests/hocr_cases.py``) must give the JAX reader's pinned page data;
   phase 3b's book with four C16 faults in its hOCR (an undefined
   ``&nbsp;``, a bare '&', an unclosed ``<meta>``, the file cut inside its
   last page) through ``recode_pdf_torch --hocr-file`` on the card and
   with ``--device cpu`` must give equal bytes, launch K1-K5 and hold the
   pinned words in its text layer; then the reader's time on phase 3's
   book hOCR and on a generated 500-page one beside stdlib
   ``ElementTree.iterparse`` over the same bytes.

The script's wall time, the card's name and power limit and the
kernels' JSON summary come before the last line (``library_ms`` is null
for every kernel: no single PyTorch call computes any of these
functions), which is
``{"ok": true, "device": {...}}``.  Without a CUDA device the run exits
1 and prints no result.

``python3 chip_smoke.py --cards`` is for a host with several cards: the
build, then phase 2e's step over every visible card against one, and
``recode_pdf_torch -J tpu`` on the 16-page book with no ``--device``
(each batch split over every card) against ``--device cuda:0``, in the
order one, all, all, one, pages/s each and the bytes equal.
"""

import glob
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, DPI, BATCH, N_PAGES = 3300, 2550, 400, 8, 16
WINDOW = 101                             # sauvola_window(400)
DEV = 'cuda:0'
ABLATE = 'tools/threshold_ablate.py:189'     # the TPU tool's _build

# csrc/<name>.cu: (wrapper module in ops/, wrapper function, TPU kernel
# it replaces)
KERNELS = {
    'optimise': ('optimise_cuda', 'optimise',
                 'archive_pdf_tools_tpu/ops/optimise_pallas.py:232'),
    'despeckle': ('denoise_cuda', 'fast_mask_denoise',
                  'archive_pdf_tools_tpu/ops/denoise_pallas.py:349'),
    'blur_sauvola': ('threshold_cuda', 'blur_sauvola',
                     'archive_pdf_tools_tpu/ops/threshold_pallas.py:233'),
    'line_sauvola': ('lines_cuda', 'line_thresholds',
                     'archive_pdf_tools_tpu/ops/lines_pallas.py:256'),
    'paste': ('paste_cuda', 'paste_lines',
              'archive_pdf_tools_tpu/ops/paste_pallas.py:203'),
    # XLA ops in the JAX package, not a Pallas kernel
    'dwt97': ('dwt97_cuda', 'dwt97',
              'archive_pdf_tools_tpu/codecs/jp2tpu.py:260'),
}
JP2_LEVELS, JP2_DELTA = 5, 1.0 / 64          # the -J tpu defaults
# H100 SXM peaks (NVIDIA's data sheet): device memory, and float32
# outside the tensor cores, taken for these kernels' scalar integer work
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12


def _wrapper_module(name):
    import importlib
    return importlib.import_module('archive_pdf_tools_tpu_torch.ops.'
                                   + KERNELS[name][0])


def _cuda_ms(fn, reps):
    """Median milliseconds of ``reps`` CUDA-event-timed calls of fn."""
    import torch
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def _nbytes(x):
    """Bytes of a tensor or a tuple of them."""
    if not isinstance(x, tuple):
        x = (x,)
    return sum(t.numel() * t.element_size() for t in x)


def _bound(nbytes, ops):
    """(ms, 'bytes' or 'operations'): the least time the card could take,
    each input byte read once and each output byte written once at the
    memory rate, or the operations at the scalar peak, the larger."""
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = ops / SCALAR_OPS_PER_S * 1e3
    return (tb, 'bytes') if tb >= to else (to, 'operations')


# integer or float operations an output element of each kernel takes in
# its plain form (estimates; every kernel here is far from them)
K1_OPS = 12         # sliding FIR and IIR sums, the division, the select
K2_OPS = 25         # 22 neighbours, the threshold, the 2-bit state
K4_OPS = 30         # a line's window sums and Sauvola test, a polarity
K5_OPS = 2          # the paste and the OR
# K4's and K5's times in their former designs (one CTA a line walking its
# rows; an atomicMax owner map), two runs of this script
FORMER = 'former design, NVIDIA H100 80GB HBM3, 700.00 W: %s ms'
DWT_OPS = 30        # 9/7 lifting in both directions, ICT, quantiser


def _k3_ops(taps):
    """Separable blur (two multiply-adds a tap a direction), window sums
    and the Sauvola test an output pixel."""
    return 4 * taps.shape[1] + 20


def _selected_bytes(lines, sel):
    """Bytes of the crops the selector pastes (one polarity a line)."""
    b = np.asarray(lines.boxes, np.int64)
    sizes = (b[:, 1] - b[:, 0]) * (b[:, 3] - b[:, 2])
    return int(sizes[np.asarray(sel) > 0].sum())


def _max_err(got, ref):
    """Largest absolute difference over a tensor or a tuple of them."""
    import torch
    if not isinstance(got, tuple):
        got, ref = (got,), (ref,)
    err = 0
    for g, r in zip(got, ref):
        if g.shape != r.shape:
            return -1
        if g.numel():
            err = max(err, int((g.to(torch.int64) - r.to(torch.int64))
                               .abs().max()))
    return err


def _compare(name, kernel_fn, plain_fn, in_bytes, ops_per_out,
             plain_reps=2, before=None):
    """Kernel vs plain on the same inputs: bit-exact, with both times and
    the bound (``in_bytes`` read, the result's bytes written, and
    ``ops_per_out`` operations an output element); ``before``: an earlier
    PR's kernel times, printed beside."""
    import torch
    got = kernel_fn()                    # warm-up + result
    ref = plain_fn()
    torch.cuda.synchronize()
    err = _max_err(got, ref)
    ms = _cuda_ms(kernel_fn, 5)
    plain_ms = _cuda_ms(plain_fn, plain_reps)
    outs = got if isinstance(got, tuple) else (got,)
    bound_ms, bound_by = _bound(in_bytes + _nbytes(got), ops_per_out
                                * sum(t.numel() for t in outs))
    print('  %-38s max_abs_err=%d  kernel %.3f ms  plain %.3f ms  bound '
          '%.4f ms (%s), kernel at %.1fx the bound%s'
          % (name, err, ms, plain_ms, bound_ms, bound_by, ms / bound_ms,
             '' if before is None else '  (%s)' % before))
    if err != 0:
        raise SystemExit('FAIL: %s differs from its plain version' % name)
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


def _check_equal(what, got, ref):
    if _max_err(got, ref) != 0:
        raise SystemExit('FAIL: %s: kernel differs from its plain version'
                         % what)


def _tests_module(name):
    """tests/<name>.py loaded by path (an installed package may own the
    top-level name 'tests')."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_' + name, os.path.join(ROOT, 'tests', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _make_page(i):
    """Book page i: a synthetic 400-DPI scan and its hOCR word data; the
    last page RGB (sepia), as tools/e2e_bench.py builds its corpus."""
    img, wd = _tests_module('scanfix').synth_scan(h=H, w=W, seed=100 + i,
                                                  dpi=DPI, fast_paper=True)
    if i == N_PAGES - 1:
        img = np.stack([img, (img * 0.93).astype(np.uint8),
                        (img * 0.82).astype(np.uint8)], axis=-1)
    return img, wd


def make_pages():
    """The N_PAGES book pages, made in parallel worker processes."""
    ctx = multiprocessing.get_context('spawn')
    with ProcessPoolExecutor(max_workers=min(8, os.cpu_count() or 1),
                             mp_context=ctx) as ex:
        return list(ex.map(_make_page, range(N_PAGES)))


def phase_build():
    import torch
    from archive_pdf_tools_tpu_torch.ops.threshold_ablate_cuda import (
        VARIANTS, build)
    from archive_pdf_tools_tpu_torch.utils import cudabuild
    print('device:', torch.cuda.get_device_name(0))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print('nvidia-smi:', smi)
    print('torch', torch.__version__, 'cuda', torch.version.cuda)
    from archive_pdf_tools_tpu_torch.codecs import jbig2, jp2host

    def host_coder():
        t = time.time()
        jp2host._get_lib()
        jbig2._get_lib()
        return time.time() - t

    t0 = time.time()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + len(VARIANTS)
                            + 1) as ex:
        t1 = ex.submit(host_coder)
        builds = [ex.submit(cudabuild.load, k, _wrapper_module(k)._SIGNATURES)
                  for k in KERNELS]
        builds += [ex.submit(build, v) for v in VARIANTS]
        for b in builds:
            b.result()
        print('g++ builds of native/jp2t1.cpp and native/jbig2.cpp (host '
              'Tier-1 and JBIG2 coders): %.2f s' % t1.result())
    print('nvcc builds, all started together: %.2f s' % (time.time() - t0))
    for name in list(KERNELS) + ['blur_sauvola.' + v for v in VARIANTS]:
        info = cudabuild.BUILD_INFO[name]
        print('nvcc build %s: %.2f s' % (name, info['seconds']))
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line:
                print('   ', line.strip())
    return smi


def phase_kernels(pages, wds):
    import torch
    from archive_pdf_tools_tpu_torch.mrc.hocr_prep import prepare_lines
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda, lines_cuda,
                                                 paste_cuda)
    from archive_pdf_tools_tpu_torch.ops.optimise import optimise as opt_plain
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_exact as den_plain
    from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise

    dev = torch.device(DEV)
    gray = torch.from_numpy(np.stack(pages)).to(dev)
    rng = np.random.default_rng(1234)
    noisy_np = np.clip(np.stack(pages).astype(np.float32)
                       + rng.normal(0, 18, (BATCH, H, W)), 0, 255)
    noisy = torch.from_numpy(noisy_np.astype(np.uint8)).to(dev)
    rgb = torch.stack([gray, (gray.to(torch.int32) + 9).clamp(0, 255)
                       .to(torch.uint8),
                       (gray.to(torch.int32) - 9).clamp(0, 255)
                       .to(torch.uint8)], dim=-1).contiguous()

    results = {}
    print('phase 2: kernels vs plain, batch %d x %dx%d' % (BATCH, H, W))
    ident = torch.zeros((BATCH, 9), dtype=torch.float32, device=dev)
    ident[:, 4] = 1.0
    cases = [('blur_sauvola identity taps r=4', gray, ident)]
    for img, bucket in ((gray, 4), (noisy, 8)):
        sig = estimate_noise(img)
        taps = D.blur_weights_from_sigma(sig, bucket).contiguous()
        print('  sigma_est %s -> bucket %d'
              % (np.round(sig.cpu().numpy(), 2).tolist(), bucket))
        cases.append(('blur_sauvola real taps r=%d' % bucket, img, taps))
    k3 = []
    for name, img, taps in cases:
        k3.append(_compare(
            name, lambda: threshold_cuda.blur_sauvola(img, taps, WINDOW),
            lambda: threshold_cuda.blur_sauvola_plain(img, taps, WINDOW),
            _nbytes((img, taps)), _k3_ops(taps)))
    results['blur_sauvola'] = (k3[1], k3)
    gmask = threshold_cuda.blur_sauvola(gray, cases[1][2], WINDOW)

    # K4 and K5 on the hOCR lines of the 8 pages
    lines = lines_cuda.RaggedLines.from_page_boxes(
        [prepare_lines(wd, W, H) for wd in wds], H, W, dev)
    heights = lines.boxes[:, 1] - lines.boxes[:, 0]
    print('  %d lines (%.1f a page), rows %d-%d, %.1f MB of crops a '
          'polarity' % (lines.n, lines.n / BATCH, heights.min(),
                        heights.max(), lines.total / 1e6))
    k4 = _compare('line_sauvola (hOCR lines)',
                  lambda: lines_cuda.line_thresholds(gray, lines, WINDOW),
                  lambda: lines_cuda.line_thresholds_plain(gray, lines,
                                                           WINDOW),
                  lines.total, K4_OPS,
                  before=FORMER % '0.482 / 0.524')
    results['line_sauvola'] = (k4, [k4])
    ct, ci, counts = lines_cuda.line_thresholds(gray, lines, WINDOW)
    sel = D.line_selector(ct, ci, counts, lines)
    print('  select_lines: %d plain, %d inverse, %d none'
          % ((sel == 1).sum(), (sel == 2).sum(), (sel == 0).sum()))
    k5 = [_compare('paste (select_lines selector)',
                   lambda: paste_cuda.paste_lines(ct, ci, lines, sel, gmask),
                   lambda: paste_cuda.paste_lines_plain(ct, ci, lines, sel,
                                                        gmask),
                   _selected_bytes(lines, sel) + _nbytes(gmask), K5_OPS,
                   before=FORMER % '0.713 / 0.822')]
    # adversarial: every box grown 40 rows down, so neighbours overlap,
    # with a random selector
    grown = lines.boxes.copy()
    grown[:, 1] = np.minimum(grown[:, 1] + 40, H)
    glines = lines_cuda.RaggedLines(grown, lines.pages, BATCH, H, W, dev)
    gct, gci, _ = lines_cuda.line_thresholds(gray, glines, WINDOW)
    gsel = rng.integers(0, 3, glines.n).astype(np.int32)
    k5.append(_compare(
        'paste (overlaps, random selector)',
        lambda: paste_cuda.paste_lines(gct, gci, glines, gsel, gmask),
        lambda: paste_cuda.paste_lines_plain(gct, gci, glines, gsel, gmask),
        _selected_bytes(glines, gsel) + _nbytes(gmask), K5_OPS,
        before=FORMER % '0.848 / 0.832'))
    results['paste'] = (k5[0], k5)
    del ct, ci, gct, gci

    mask = threshold_cuda.blur_sauvola(gray, cases[1][2], WINDOW)
    r = _compare('despeckle (sauvola mask)',
                 lambda: denoise_cuda.fast_mask_denoise(mask, 4, 2),
                 lambda: den_plain(mask, 4, 2), _nbytes(mask), K2_OPS)
    results['despeckle'] = (r, [r])
    mask = denoise_cuda.fast_mask_denoise(mask, 4, 2)
    inv = ~mask

    k1 = []
    for name, m, img, n in (('optimise gray fg n=3', mask, gray, 3),
                            ('optimise gray bg n=10', inv, gray, 10),
                            ('optimise rgb fg n=3', mask, rgb, 3),
                            ('optimise rgb bg n=10', inv, rgb, 10)):
        k1.append(_compare(name,
                           lambda: optimise_cuda.optimise(m, img, n),
                           lambda: opt_plain(m, img, n), _nbytes((m, img)),
                           K1_OPS))
    results['optimise'] = (k1[1], k1)

    # the JPEG2000 transform of what -J tpu gives it: the fills' layers
    layers = (('dwt97 gray fg layer', optimise_cuda.optimise(mask, gray, 3)),
              ('dwt97 rgb bg layer', optimise_cuda.optimise(inv, rgb, 10)))
    dwt = [_compare_dwt97(n, x) for n, x in layers]
    results['dwt97'] = (dwt[0], dwt)
    return results


def _flat_bands(comps):
    return tuple(b for comp in comps for b in comp)


def _compare_dwt97(name, x, levels=JP2_LEVELS, delta=JP2_DELTA):
    from archive_pdf_tools_tpu_torch.ops import dwt97_cuda
    from archive_pdf_tools_tpu_torch.ops.dwt97 import dwt97 as dwt_plain
    return _compare('%s L=%d' % (name, levels),
                    lambda: _flat_bands(dwt97_cuda.dwt97(x, levels, delta)),
                    lambda: _flat_bands(dwt_plain(x, levels, delta)),
                    _nbytes(x), DWT_OPS)


# phase 2b's edge cases of K1 (batch, rows, columns, channels, n, share of
# mask pixels) and K2 (batch, rows, columns, share of ink);
# tests/test_torch_ops.py holds the plain versions to the JAX package at
# the small ones
K1_EDGES = ((2, 3, 31, 1, 3, 0.3), (1, 4, 19, 3, 10, 0.3),
            (2, 5, 6, 1, 3, 0.3), (1, 2, 70, 3, 1, 0.3),
            (1, 97, 301, 3, 1, 0.3), (2, 64, 65, 3, 10, 0.3),
            (1, 40, 33, 1, 3, 1.0), (1, 40, 33, 3, 10, 0.0),
            (1, 40, 33, 3, 3, 1.0), (1, 300, 1030, 3, 3, 0.3),
            (1, 120, 2551, 3, 10, 0.3), (1, 30, 5100, 1, 10, 0.3),
            (1, 16, 7000, 1, 3, 0.3))
K2_EDGES = ((2, 4, 40, 0.5), (1, 3, 37, 0.5), (2, 50, 4, 0.5),
            (1, 97, 301, 0.3), (1, 97, 301, 0.5), (1, 97, 301, 0.7),
            (2, 300, 1030, 0.3), (2, 300, 1030, 0.5), (2, 300, 1030, 0.7),
            (1, 40, 33, 1.0), (1, 40, 33, 0.0), (1, 257, 2551, 0.5),
            (1, 64, 9000, 0.5), (1, 16, 32768, 0.5))


def _stroke_page(rng, h, w):
    """Light paper, dark strokes, gaussian noise (tests/test_kernels.py
    synth_page, which imports jax)."""
    img = np.full((h, w), 235.0)
    for _ in range(60):
        y, x = rng.integers(5, h - 15), rng.integers(5, w - 40)
        img[y:y + rng.integers(2, 5), x:x + rng.integers(10, 35)] = \
            rng.integers(10, 60)
    img += rng.normal(0, 20, size=(h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def _bright_page(rng, h, w):
    """Bright paper (240-255) with mid-grey strokes: window sums of
    squares near 65025 * window^2."""
    img = rng.integers(240, 256, (h, w)).astype(np.uint8)
    for y in range(8, h - 8, 23):
        for x in range(10, w - 14, 9):
            img[y:y + 5, x:x + 4] = 150
    return img


def phase_odd_shapes():
    """Kernel == plain at small and ragged shapes: windows and blur
    radii larger than the page, widths under one warp, odd batches,
    ragged hOCR lines, and windows whose sum of squares passes 2^31."""
    import torch
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda, lines_cuda,
                                                 paste_cuda)
    from archive_pdf_tools_tpu_torch.ops.optimise import optimise as opt_plain
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_exact as den_plain
    from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise
    dev = torch.device(DEV)
    rng = np.random.default_rng(99)
    n_cases = 0
    for b, h, w in ((1, 1, 1), (2, 5, 7), (1, 40, 33), (3, 97, 301),
                    (2, 300, 1030)):
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w),
                                            dtype=np.uint8)).to(dev)
        sig = torch.from_numpy(rng.uniform(8, 40, b).astype(np.float32))
        for r, window in ((4, 31), (16, 101)):
            taps = D.blur_weights_from_sigma(sig.to(dev), r).contiguous()
            _check_equal('blur_sauvola at %s r=%d' % ((b, h, w), r),
                         threshold_cuda.blur_sauvola(img, taps, window),
                         threshold_cuda.blur_sauvola_plain(img, taps,
                                                           window))
            n_cases += 1
        mask = torch.from_numpy(rng.random((b, h, w)) < 0.3).to(dev)
        _check_equal('despeckle at %s' % ((b, h, w),),
                     denoise_cuda.fast_mask_denoise(mask, 4, 2),
                     den_plain(mask, 4, 2))
        rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                            dtype=np.uint8)).to(dev)
        for im in (img, rgb):
            for m, n in ((mask, 3), (~mask, 10)):
                _check_equal('optimise at %s n=%d' % (tuple(im.shape), n),
                             optimise_cuda.optimise(m, im, n),
                             opt_plain(m, im, n))
        n_cases += 5

    # the redesigned K1 and K2 at their edges: widths off the warp and
    # word grain and below 2n+1 columns, fewer than 5 rows, masks all set
    # and all clear, the despeckle on uniform noise at 30/50/70% ink (long
    # runs of every kind of column), pages up to each kernel's widest
    for b, h, w, ink in K2_EDGES:
        mask = torch.from_numpy(rng.random((b, h, w)) < ink).to(dev)
        _check_equal('despeckle at %s, %d%% ink' % ((b, h, w), 100 * ink),
                     denoise_cuda.fast_mask_denoise(mask, 4, 2),
                     den_plain(mask, 4, 2))
        n_cases += 1
    for b, h, w, c, n, ink in K1_EDGES:
        mask = torch.from_numpy(rng.random((b, h, w)) < ink).to(dev)
        img = torch.from_numpy(rng.integers(
            0, 256, (b, h, w) + ((c,) if c > 1 else ()),
            dtype=np.uint8)).to(dev)
        _check_equal('optimise at %s n=%d, %d%% mask'
                     % (tuple(img.shape), n, 100 * ink),
                     optimise_cuda.optimise(mask, img, n),
                     opt_plain(mask, img, n))
        n_cases += 1
    # K1 rows wider than one CTA's shared memory, split over a cluster of
    # CTAs: the widest one-CTA strip and one column more, 19,370 columns
    # (timed), the widest row a cluster takes, and one column more, which
    # runs as the wavefront of strips
    for n in (3, 10):
        wmax = optimise_cuda.max_width(n)
        one = optimise_cuda.one_cta(n)
        for b, h, w, c in ((1, 64, one, 1), (1, 64, one + 1, 3),
                           (2, 400, 19370, 1), (1, 400, 19370, 3),
                           (1, 16, wmax, 1), (1, 16, wmax + 1, 1),
                           (2, 24, wmax + 1, 3)):
            mask = torch.from_numpy(rng.random((b, h, w)) < 0.3).to(dev)
            img = torch.from_numpy(rng.integers(
                0, 256, (b, h, w) + ((c,) if c > 1 else ()),
                dtype=np.uint8)).to(dev)
            what = 'optimise %s n=%d, %d CTAs a row' % (
                tuple(img.shape), n, optimise_cuda.strips(w, n))
            if w == 19370:
                _compare(what, lambda: optimise_cuda.optimise(mask, img, n),
                         lambda: opt_plain(mask, img, n),
                         _nbytes((mask, img)), K1_OPS)
            else:
                _check_equal(what, optimise_cuda.optimise(mask, img, n),
                             opt_plain(mask, img, n))
            n_cases += 1

    # K3 where the window sum of squares passes 2^31 (dpi >= 728)
    bright = torch.from_numpy(np.stack([_bright_page(rng, 520, 640)
                                        for _ in range(2)])).to(dev)
    sig = estimate_noise(bright)
    for window in (183, 201):
        for taps in (D.blur_weights_from_sigma(sig, 4).contiguous(),
                     D.blur_weights_from_sigma(sig * 0, 4).contiguous()):
            got = threshold_cuda.blur_sauvola(bright, taps, window)
            ref = threshold_cuda.blur_sauvola_plain(bright, taps, window)
            _check_equal('blur_sauvola window %d' % window, got, ref)
            if not (ref.any() and got.any()):
                raise SystemExit('FAIL: blur_sauvola window %d marks no ink'
                                 % window)
            n_cases += 1

    # K4 / K5 at ragged line shapes; page 2 of the batch has no lines
    b, h, w = 3, 700, 500
    gray = torch.from_numpy(np.stack([_stroke_page(rng, h, w)
                                      for _ in range(b)])).to(dev)
    boxes = [[0, 1, 0, 500], [5, 6, 10, 300],          # one-row lines
             [20, 640, 30, 470],                       # tall: 620 rows
             [100, 130, 200, 205], [300, 302, 7, 8],   # narrower than window
             [690, 700, 400, 500], [0, 700, 480, 500],  # page edges
             [40, 90, 0, 500], [60, 110, 0, 250]]      # overlapping
    pages = [0, 0, 0, 1, 1, 1, 1, 0, 0]
    lines = lines_cuda.RaggedLines(boxes, pages, b, h, w, dev)
    gmask = torch.from_numpy(rng.random((b, h, w)) < 0.05).to(dev)
    for window in (31, 101):
        got = lines_cuda.line_thresholds(gray, lines, window)
        ref = lines_cuda.line_thresholds_plain(gray, lines, window)
        _check_equal('line_sauvola ragged lines window %d' % window, got,
                     ref)
        ct, ci, counts = got
        real = D.line_selector(ct, ci, counts, lines)
        for sel in (real, np.zeros(lines.n, np.int32),
                    rng.integers(0, 3, lines.n).astype(np.int32)):
            out = paste_cuda.paste_lines(ct, ci, lines, sel, gmask)
            _check_equal('paste ragged lines window %d' % window, out,
                         paste_cuda.paste_lines_plain(ct, ci, lines, sel,
                                                      gmask))
            if not torch.equal(out[2], gmask[2]) or \
                    (not sel.any() and not torch.equal(out, gmask)):
                raise SystemExit('FAIL: paste changed a page without a '
                                 'selected line')
        n_cases += 4
    n_cases += phase_line_shapes(rng, gray)
    empty = lines_cuda.RaggedLines.from_page_boxes([[]] * b, h, w, dev)
    ect, eci, _ = lines_cuda.line_thresholds(gray, empty, 31)
    _check_equal('paste with no lines',
                 paste_cuda.paste_lines(ect, eci, empty, [], gmask), gmask)
    n_cases += 1

    # the JPEG2000 transform: odd sizes, one-page batches, levels capped
    # by the page (as the encoder caps them) and not, sizes around the
    # tile (56 x 120 outputs) and its halo
    from archive_pdf_tools_tpu_torch.codecs.jp2tpu import capped_levels
    from archive_pdf_tools_tpu_torch.ops import dwt97_cuda
    from archive_pdf_tools_tpu_torch.ops.dwt97 import dwt97 as dwt_plain
    for b, h, w, levels in ((1, 1, 1, 5), (2, 5, 7, 5), (1, 40, 33, 5),
                            (3, 97, 301, 5), (2, 300, 1031, 5),
                            (1, 3301, 2549, 5), (2, 64, 48, 5),
                            (2, 33, 1030, 4), (1, 257, 193, 1),
                            (1, 57, 121, 3), (1, 113, 244, 2),
                            (2, 60, 124, 1)):
        lv = capped_levels(h, w, levels) if levels == 5 else levels
        for rgb in (False, True):
            img = torch.from_numpy(rng.integers(
                0, 256, (b, h, w) + ((3,) if rgb else ()),
                dtype=np.uint8)).to(dev)
            for delta in (JP2_DELTA, 0.5):
                _check_equal('dwt97 at %s L=%d delta %g'
                             % (tuple(img.shape), lv, delta),
                             _flat_bands(dwt97_cuda.dwt97(img, lv, delta)),
                             _flat_bands(dwt_plain(img, lv, delta)))
                n_cases += 1
    n_cases += phase_widest(rng)
    torch.cuda.synchronize()
    print('phase 2b: %d odd-shape cases, kernel == plain' % n_cases)


def phase_line_shapes(rng, gray):
    """K4 on lines of every height from 1 to 60 rows (1 to 60 distinct
    vertical windows at window 31, 1 to 19 at window 101) and taller ones
    up to 300 rows, as the kernel's units and window runs cut them; K5 on
    overlapping boxes whose lines are not sorted by page."""
    import torch
    from archive_pdf_tools_tpu_torch.ops import lines_cuda, paste_cuda
    dev = torch.device(DEV)
    b, h, w = gray.shape
    boxes = [[5 + (7 * k) % 400, 5 + (7 * k) % 400 + k, (37 * k) % 150,
              (37 * k) % 150 + 40 + 5 * k] for k in range(1, 61)]
    boxes += [[0, 300, 0, w], [100, 399, 33, 290], [350, 640, 1, 2],
              [390, 690, 120, 121 + lines_cuda.TILE_COLS // 2]]
    pages = [(3 * k) % b for k in range(len(boxes))]
    lines = lines_cuda.RaggedLines(boxes, pages, b, h, w, dev)
    runs = [lines_cuda.distinct_windows(bb - t, 101)
            for t, bb, _l, _r in boxes]
    print('  K4 lines of 1-60 and 290-300 rows: %d units, %d-%d distinct '
          'windows a line at window 101'
          % (len(lines_cuda.line_units(lines.boxes, 101)[0]), min(runs),
             max(runs)))
    n = 0
    for window in (31, 101):
        got = lines_cuda.line_thresholds(gray, lines, window)
        _check_equal('line_sauvola lines of 1-300 rows window %d' % window,
                     got, lines_cuda.line_thresholds_plain(gray, lines,
                                                           window))
        n += 1
    # overlapping boxes, lines out of page order, a page with none
    ct, ci, _ = got
    gmask = torch.from_numpy(rng.random((b, h, w)) < 0.05).to(dev)
    for sel in (np.ones(lines.n, np.int32),
                rng.integers(0, 3, lines.n).astype(np.int32)):
        _check_equal('paste overlapping lines out of page order',
                     paste_cuda.paste_lines(ct, ci, lines, sel, gmask),
                     paste_cuda.paste_lines_plain(ct, ci, lines, sel, gmask))
        n += 1
    return n


# phase 2b's widest inputs: PDF's largest page, 200 inches, at 600 DPI
WIDEST = 120000


def phase_widest(rng):
    """K1 (n=3 and n=10, gray and RGB), K2, K3 and B7 on pages of
    WIDEST columns, K2 also at the widest page one CTA takes and one
    column more (the wavefront); K4 on a line of WIDEST columns and on
    one just past a tile (K5 pasting both): each kernel == its plain
    version, the page and line kernels timed.  Few rows, so the plain
    versions stay quick."""
    import torch
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import (denoise_cuda, threshold_cuda,
                                                 lines_cuda, paste_cuda,
                                                 dwt97_cuda)
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_exact as den_plain
    from archive_pdf_tools_tpu_torch.ops.dwt97 import dwt97 as dwt_plain
    from archive_pdf_tools_tpu_torch.ops import optimise_cuda
    from archive_pdf_tools_tpu_torch.ops.optimise import optimise as opt_plain
    dev = torch.device(DEV)
    n = 0
    wmax = denoise_cuda.max_width()
    for b, h, w in ((1, 16, 32769), (1, 16, wmax), (1, 16, wmax + 1),
                    (2, 32, 47104), (1, 64, WIDEST)):
        mask = torch.from_numpy(rng.random((b, h, w)) < 0.5).to(dev)
        what = 'despeckle %s, %d CTAs a row' % ((b, h, w),
                                                denoise_cuda.strips(w))
        if w in (47104, WIDEST):
            _compare(what, lambda: denoise_cuda.fast_mask_denoise(mask, 4, 2),
                     lambda: den_plain(mask, 4, 2), _nbytes(mask), K2_OPS)
        else:
            _check_equal(what, denoise_cuda.fast_mask_denoise(mask, 4, 2),
                         den_plain(mask, 4, 2))
        n += 1
    # K1's wavefront: 16 rows of WIDEST columns, gray and RGB
    for c in (1, 3):
        mask = torch.from_numpy(rng.random((1, 16, WIDEST)) < 0.3).to(dev)
        img = torch.from_numpy(rng.integers(
            0, 256, (1, 16, WIDEST) + ((c,) if c > 1 else ()),
            dtype=np.uint8)).to(dev)
        for k in (3, 10):
            _compare('optimise %s n=%d, %d CTAs a row'
                     % (tuple(img.shape), k, optimise_cuda.strips(WIDEST, k)),
                     lambda: optimise_cuda.optimise(mask, img, k),
                     lambda: opt_plain(mask, img, k), _nbytes((mask, img)),
                     K1_OPS)
            n += 1

    page = np.stack([_stroke_page(rng, 48, WIDEST) for _ in range(2)])
    gray = torch.from_numpy(page).to(dev)
    sig = torch.from_numpy(rng.uniform(8, 40, 2).astype(np.float32)).to(dev)
    for r, window in ((4, 101), (16, 255)):
        taps = D.blur_weights_from_sigma(sig, r).contiguous()
        _compare('blur_sauvola %s r=%d window %d' % (tuple(gray.shape), r,
                                                     window),
                 lambda: threshold_cuda.blur_sauvola(gray, taps, window),
                 lambda: threshold_cuda.blur_sauvola_plain(gray, taps, window),
                 _nbytes((gray, taps)), _k3_ops(taps))
        n += 1
    rgb = torch.from_numpy(np.stack([page, page // 2, 255 - page], -1)) \
        .to(dev)
    for x in (gray[:, :32].contiguous(), rgb[:1, :32].contiguous()):
        _compare('dwt97 %s L=%d' % (tuple(x.shape), JP2_LEVELS),
                 lambda: _flat_bands(dwt97_cuda.dwt97(x, JP2_LEVELS,
                                                      JP2_DELTA)),
                 lambda: _flat_bands(dwt_plain(x, JP2_LEVELS, JP2_DELTA)),
                 _nbytes(x), DWT_OPS)
        n += 1

    # K4: one line across the whole widest page, one just past a tile
    # (TILE_COLS + 1 columns, two CTAs), beside an ordinary one
    past = lines_cuda.TILE_COLS + 1
    boxes = [[4, 40, 0, WIDEST], [10, 22, 300, 300 + past],
             [20, 44, 1000, 3550]]
    lines = lines_cuda.RaggedLines(boxes, [0, 1, 1], 2, 48, WIDEST, dev)
    units, _ = lines_cuda.line_units(lines.boxes, WINDOW)
    print('  K4 widest lines: %d units for lines of %s columns'
          % (len(units), [r - l for _t, _b, l, r in boxes]))
    _compare('line_sauvola widest lines',
             lambda: lines_cuda.line_thresholds(gray, lines, WINDOW),
             lambda: lines_cuda.line_thresholds_plain(gray, lines, WINDOW),
             lines.total, K4_OPS)
    ct, ci, counts = lines_cuda.line_thresholds(gray, lines, WINDOW)
    gmask = torch.from_numpy(rng.random((2, 48, WIDEST)) < 0.05).to(dev)
    for sel in (np.array([1, 2, 1], np.int32), np.array([2, 1, 2], np.int32)):
        _check_equal('paste widest lines',
                     paste_cuda.paste_lines(ct, ci, lines, sel, gmask),
                     paste_cuda.paste_lines_plain(ct, ci, lines, sel, gmask))
    return n + 3


def _write_hocr(tmp, name, pages, wds):
    """An hOCR file whose lines are ``wds``' line boxes (one word a line;
    none when wds holds empty pages)."""
    fx = _tests_module('fixtures')
    hocr = []
    for i, (page, wd) in enumerate(zip(pages, wds)):
        words = [tuple(line['bbox']) + ('synthword',)
                 for para in wd for line in para['lines']]
        hocr.append(fx.words_to_hocr_page(words, page.shape[1],
                                          page.shape[0], page_no=i,
                                          dpi=DPI))
    hocr_path = os.path.join(tmp, name + '.hocr')
    with open(hocr_path, 'w', encoding='utf-8') as fp:
        fp.write(fx.HOCR_TEMPLATE % '\n'.join(hocr))
    return hocr_path


def _write_book(tmp, name, pages, wds):
    """Page PNGs plus their hOCR file."""
    from PIL import Image
    for i, page in enumerate(pages):
        Image.fromarray(page).save(os.path.join(tmp, '%s_%04d.png'
                                                % (name, i)))
    return (os.path.join(tmp, name + '_*.png'),
            _write_hocr(tmp, name, pages, wds))


def _counted(fn):
    """fn() with every kernel's launch count set to 0 before; returns
    (its result, the counts)."""
    counters = {name: getattr(_wrapper_module(name), KERNELS[name][1])
                for name in KERNELS}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {k: f.launches for k, f in counters.items()}


def _run_cli(args, out, insize, n_pages, need, device=DEV):
    """One recode_pdf_torch CLI run on ``device`` (None: no --device,
    every visible card); its output must pass the PDF/A validator and
    the launch counts of that run reach ``need``.  Returns the counts."""
    from archive_pdf_tools_tpu_torch.validators import validate_pdfa
    from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
    args = list(args) + ['-o', out, '-v']
    if device:
        args += ['--device', device]
    t0 = time.time()
    rc, launches = _counted(lambda: main(args))
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit('FAIL: recode_pdf_torch exited %d' % rc)
    validate_pdfa(out)
    print('  wall %.3f s = %.4f pages/s; compression ratio %.3f; '
          'PDF/A valid; launches %s'
          % (wall, n_pages / wall, insize / os.path.getsize(out), launches))
    for k, n in need.items():
        if launches[k] < n:
            raise SystemExit('FAIL: %s launched %d times on the path, '
                             'expected >= %d' % (k, launches[k], n))
    return launches


def run_book(tmp, name, pages, wds, extra, need):
    """One recode_pdf_torch CLI run on an image stack."""
    glob_pat, hocr_path = _write_book(tmp, name, pages, wds)
    n_lines = sum(len(para['lines']) for wd in wds for para in wd)
    print('phase 3: recode_pdf_torch %s, %d pages of %dx%d at %d DPI, '
          '%d hOCR lines' % (' '.join(extra) or '(default flags)',
                             len(pages), H, W, DPI, n_lines))
    insize = sum(os.path.getsize(p) for p in glob.glob(glob_pat))
    return _run_cli(['--from-imagestack', glob_pat, '--hocr-file', hocr_path,
                     '--dpi', str(DPI)] + list(extra),
                    os.path.join(tmp, name + '.pdf'), insize, len(pages),
                    need)


def check_jpx(pdf_path):
    """Every JPX stream of the PDF passes the strict JPEG2000 validator
    (a packet walk of the in-tree encoder's profile) and decodes with
    Pillow at its size; in each, the cheapest coded block decodes with
    the from-spec Tier-1 decoder, and the native coder re-encodes the
    decoded coefficients to the stored bytes (all but the flush-affected
    last 4), as ``validate_pdfa(strict_jpx_decode=...)`` checks."""
    import io
    from PIL import Image
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    from archive_pdf_tools_tpu_torch.validators.jp2_check import validate_jp2
    from archive_pdf_tools_tpu_torch.validators.jp2t1_check import decode_block
    from archive_pdf_tools_tpu_torch.codecs import jp2host
    lib = jp2host._get_lib()
    rd = PdfReader(pdf_path)
    n = 0
    for page in range(rd.page_count()):
        for _n, _x, s in rd.page_images(page):
            if str(rd.resolve(s.dict['Filter'])) != 'JPXDecode':
                continue
            blks = []
            facts = validate_jp2(s.raw, collect_blocks=blks)
            with Image.open(io.BytesIO(s.raw)) as im:
                im.load()
                if im.size != (facts['w'], facts['h']) or not facts[
                        'packet_walk']:
                    raise SystemExit('FAIL: JPX stream %d of page %d: '
                                     'size or packet walk' % (n, page))
            coded = [b for b in blks if b['npasses']]
            rec = min(coded, key=lambda b: b['w'] * b['h'] * b['npasses'])
            mag, sgn = decode_block(rec['data'], rec['w'], rec['h'],
                                    rec['orient'], rec['nbps'],
                                    rec['npasses'])
            coeffs = (np.asarray(mag, np.int64)
                      * (1 - 2 * np.asarray(sgn, np.int64))).astype(
                          np.int32).reshape(rec['h'], rec['w'])
            data2, nbps2, np2, _r, _d = jp2host._encode_block(
                lib, coeffs, rec['orient'], max_passes=rec['npasses'])
            stored = bytes(rec['data'])
            k = max(0, min(len(stored), len(data2)) - 4)
            if (nbps2, np2) != (rec['nbps'], rec['npasses']) or \
                    bytes(data2[:k]) != stored[:k]:
                raise SystemExit('FAIL: JPX stream %d of page %d: Tier-1 '
                                 'decode/re-encode differs' % (n, page))
            n += 1
    print('  %d JPX streams: strict validator, Pillow decode and a '
          'Tier-1 decode/re-encode each' % n)
    if n != 2 * rd.page_count():
        raise SystemExit('FAIL: expected 2 JPX streams a page, found %d'
                         % n)


def phase_from_pdf(tmp, pages, wds, need):
    """--from-pdf with -T on a PDF that Pillow writes, one JPEG a page."""
    from PIL import Image
    hocr_path = _write_hocr(tmp, 'pdfbook', pages, wds)
    src = os.path.join(tmp, 'pillow.pdf')
    ims = [Image.fromarray(p) for p in pages]
    ims[0].save(src, save_all=True, append_images=ims[1:], resolution=DPI)
    print('phase 3c: recode_pdf_torch --from-pdf -T, %d pages of %dx%d at '
          '%d DPI, one JPEG a page, written by Pillow (%.1f MB)'
          % (len(pages), H, W, DPI, os.path.getsize(src) / 1e6))
    _run_cli(['--from-pdf', src, '--hocr-file', hocr_path],
             os.path.join(tmp, 'pdfbook.pdf'), os.path.getsize(src),
             len(pages), need)


def phase_small_book(tmp):
    """The card and the CPU's plain versions give the same PDF bytes on
    a noise-free worded book (identity blur taps: float exp and sum
    order, which may differ between CPU and GPU libraries, never
    enter)."""
    from PIL import Image
    from archive_pdf_tools_tpu_torch import recode
    fx = _tests_module('fixtures')
    os.environ['SOURCE_DATE_EPOCH'] = '1700000000'
    hocr = []
    for i in range(3):
        img, words = fx.render_book_page(320, 416, seed=i, rgb=i == 1,
                                         noise=0)
        Image.fromarray(img).save(os.path.join(tmp, 'small_%04d.png' % i))
        hocr.append(fx.words_to_hocr_page(words, 320, 416, page_no=i,
                                          dpi=100))
    hocr_path = os.path.join(tmp, 'small.hocr')
    with open(hocr_path, 'w', encoding='utf-8') as fp:
        fp.write(fx.HOCR_TEMPLATE % '\n'.join(hocr))
    for impl, sfx in (('pillow', ''), ('tpu', '_tpu')):
        outs = {}
        for dev in (DEV, 'cpu'):
            outs[dev] = os.path.join(tmp, 'small%s_%s.pdf' % (
                sfx, 'card' if dev == DEV else 'cpu'))
            recode(from_imagestack=os.path.join(tmp, 'small_*.png'),
                   hocr_file=hocr_path, out_pdf=outs[dev], dpi=100,
                   jbig2=True, jpeg2000_implementation=impl, device=dev)
        with open(outs[DEV], 'rb') as a, open(outs['cpu'], 'rb') as b:
            same = a.read() == b.read()
        print('phase 3b: 3-page noise-free worded book, -J %s, card vs CPU '
              'plain path: %s' % (impl, 'byte-identical' if same
                                  else 'DIFFERENT'))
        if not same:
            raise SystemExit('FAIL: card and CPU recode differ (-J %s)'
                             % impl)


def phase_small_from_pdf(tmp, need):
    """--from-pdf without -T on the small book's own MRC PDF (two images
    and a text layer a page): hOCR from its text layer, each page
    rendered whole."""
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    src = os.path.join(tmp, 'small_card.pdf')
    out = os.path.join(tmp, 'small_frompdf.pdf')
    print('phase 3c: recode_pdf_torch --from-pdf without -T, the 3-page '
          'small book\'s MRC PDF')
    _run_cli(['--from-pdf', src], out, os.path.getsize(src), 3, need)
    rd = PdfReader(out)
    if rd.page_count() != 3 or b'TJ' not in rd.page_contents(0):
        raise SystemExit('FAIL: --from-pdf without -T lost pages or text')


def phase_scandata(tmp, need):
    """The small book with --scandata-file: a skipped page, page labels."""
    import pathlib
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    sd = _tests_module('fixtures').make_scandata(
        pathlib.Path(tmp), 3, dpi=100, skip=(1,), numbers=['1', None, '3'])
    glob_pat = os.path.join(tmp, 'small_*.png')
    out = os.path.join(tmp, 'small_scandata.pdf')
    print('phase 3c: recode_pdf_torch --scandata-file, the 3-page small '
          'book, one page skipped')
    kept = [p for i, p in enumerate(sorted(glob.glob(glob_pat))) if i != 1]
    _run_cli(['--from-imagestack', glob_pat, '--hocr-file',
              os.path.join(tmp, 'small.hocr'), '--scandata-file', sd],
             out, sum(os.path.getsize(p) for p in kept), 2, need)
    rd = PdfReader(out)
    if rd.page_count() != 2 or 'PageLabels' not in rd.catalog:
        raise SystemExit('FAIL: --scandata-file: pages or labels wrong')


def _cuda_peak(fn, reps=3):
    """(median CUDA-event ms of ``reps`` calls, peak device memory in MB
    that a call allocates beyond what was in use before it)."""
    import torch
    fn()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    ms = _cuda_ms(fn, reps)
    return ms, (torch.cuda.max_memory_allocated() - base) / 1e6


def _leave_two_cores():
    """The CPU references' thread computes on all but two host cores;
    those are left to the thread that drives the card."""
    import torch
    torch.set_num_threads(max(1, (os.cpu_count() or 2) - 2))


def _cpu_tv_reference(page):
    """The page's Sauvola mask (the plain K3 on the CPU, host taps) and
    its TV denoise > 0.4 on the CPU: phase 2d's reference, run on a
    thread while the card runs phases 2-2c."""
    import torch
    from archive_pdf_tools_tpu_torch.ops.tv import denoise_tv_bregman
    from archive_pdf_tools_tpu_torch.parallel.sharded import \
        sharded_global_threshold
    t = time.time()
    (mask,) = sharded_global_threshold([torch.from_numpy(page[None])],
                                       WINDOW)
    tv = denoise_tv_bregman(mask.to(torch.float32)) > 0.4
    return mask, tv, time.time() - t


def phase_offpath_ops(pages, tv_ref):
    """2d: the off-path ops on the card against their CPU form."""
    import torch
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_jacobi
    from archive_pdf_tools_tpu_torch.ops.grayconvert import \
        special_gray_convert
    from archive_pdf_tools_tpu_torch.ops.tv import denoise_tv_bregman
    from archive_pdf_tools_tpu_torch.parallel.sharded import \
        sharded_global_threshold
    print('phase 2d: off-path ops (torch ops) on the card vs their CPU '
          'form, %dx%d' % (H, W))
    rgb = torch.from_numpy(pages[N_PAGES - 1][None])
    rgb_dev = rgb.to(DEV)
    _check_equal('special_gray_convert',
                 special_gray_convert(rgb_dev).cpu(),
                 special_gray_convert(rgb))
    ms, mb = _cuda_peak(lambda: special_gray_convert(rgb_dev))
    print('  special_gray_convert 1 RGB page: == CPU; %.3f ms, peak %.1f MB'
          % (ms, mb))
    del rgb_dev

    gray = torch.from_numpy(np.stack(pages[:BATCH])).to(DEV)
    (mask,) = sharded_global_threshold([gray], WINDOW)
    _check_equal('fast_mask_denoise_jacobi',
                 fast_mask_denoise_jacobi(mask, 4, 2).cpu(),
                 fast_mask_denoise_jacobi(mask.cpu(), 4, 2))
    ms, mb = _cuda_peak(lambda: fast_mask_denoise_jacobi(mask, 4, 2))
    print('  fast_mask_denoise_jacobi batch %d: == CPU; %.3f ms, peak %.1f '
          'MB' % (BATCH, ms, mb))

    # the card's work first, then the wait for the CPU form
    card_tv = (denoise_tv_bregman(mask[:1].to(torch.float32)) > 0.4).cpu()
    ms1, mb1 = _cuda_peak(
        lambda: denoise_tv_bregman(mask[:1].to(torch.float32)), reps=1)
    maskf = mask.to(torch.float32)
    ms8, mb8 = _cuda_peak(lambda: denoise_tv_bregman(maskf), reps=1)
    cpu_mask, cpu_tv, cpu_s = tv_ref.result()
    _check_equal('phase 2d TV input (K3 vs plain, host taps)',
                 mask[:1].cpu(), cpu_mask)
    agree = float((card_tv == cpu_tv).to(torch.float64).mean())
    print('  denoise_tv_bregman 1 page: > 0.4 agrees with CPU at %.7f '
          '(CPU form %.1f s on a thread); %.3f ms, peak %.1f MB'
          % (agree, cpu_s, ms1, mb1))
    if agree < 0.9999:
        raise SystemExit('FAIL: TV denoise on the card differs from the '
                         'CPU (%.7f)' % agree)
    plane = maskf.numel() * 4 / 1e6
    # live inside an fma: u, d and b (two planes each), the gradients,
    # the norm, the shrink and a temporary in float32, and ~7 float64
    # planes (the product, the sum, TwoSum's terms, the rounded sum)
    print('  denoise_tv_bregman batch %d: %.3f ms, peak %.1f MB (%.0f MB a '
          'float32 plane; ~10 float32 and ~7 float64 planes reckoned: '
          '%.0f MB)' % (BATCH, ms8, mb8, plane, 24 * plane))


def _jbig2_masks(pdf_path):
    """The decoded bits of every JBIG2 image or soft mask of the PDF, in
    page and image order."""
    from archive_pdf_tools_tpu_torch.codecs.jbig2 import decode_jbig2
    from archive_pdf_tools_tpu_torch.pdf.reader import PdfReader
    rd = PdfReader(pdf_path)
    out = []
    for page in range(rd.page_count()):
        for _n, _x, s in rd.page_images(page):
            for im in (s, rd.resolve(s.dict.get('SMask'))):
                if im is not None and str(rd.resolve(
                        im.dict.get('Filter'))) == 'JBIG2Decode':
                    out.append(decode_jbig2(
                        im.raw, int(rd.resolve(im.dict['Width'])),
                        int(rd.resolve(im.dict['Height']))))
    return out


def phase_small_options(tmp):
    """3d: each recode option off the main path on the small book (phase
    3b's), on the card and on the CPU."""
    from archive_pdf_tools_tpu_torch import recode
    src = os.path.join(tmp, 'small_card.pdf')
    base = dict(from_imagestack=os.path.join(tmp, 'small_*.png'),
                hocr_file=os.path.join(tmp, 'small.hocr'), dpi=100,
                jbig2=True)
    cases = [('--grayscale-pdf', dict(grayscale_pdf=True)),
             ('--bw-pdf', dict(force_1bit_output=True)),
             ('--jbig2-bands 2', dict(jbig2_bands=2)),
             ('--approx-denoise', dict(exact_denoise=False)),
             ('--denoise-mask bregman', dict(denoise_mask='bregman')),
             ('-m 0 --from-pdf', dict(image_mode=0, from_pdf=src,
                                      from_imagestack=None, dpi=None)),
             ('-m 1 --from-pdf', dict(image_mode=1, from_pdf=src,
                                      from_imagestack=None, dpi=None))]
    cases += [('--jbig2-symbol-coding %s' % m,
               dict(jbig2_symbol_mode=True if m == 'on' else m))
              for m in ('on', 'auto', 'lossy', 'refine')]
    for label, kw in cases:
        outs = []
        for dev in (DEV, 'cpu'):
            outs.append(os.path.join(tmp, 'opt_%s.pdf' % dev[:3]))
            recode(out_pdf=outs[-1], device=dev, **dict(base, **kw))
        with open(outs[0], 'rb') as a, open(outs[1], 'rb') as b:
            same = a.read() == b.read()
        if 'denoise_mask' in kw:
            ma, mb = _jbig2_masks(outs[0]), _jbig2_masks(outs[1])
            agree = min(float((a == b).mean()) for a, b in zip(ma, mb))
            print('  %-28s card vs CPU: masks agree at %.6f (bytes %s)'
                  % (label, agree, 'equal' if same else 'differ'))
            if len(ma) != 3 or len(mb) != 3 or agree < 0.9999:
                raise SystemExit('FAIL: %s: card and CPU masks differ'
                                 % label)
            continue
        print('  %-28s card vs CPU: %s' % (label, 'byte-identical' if same
                                          else 'DIFFERENT'))
        if not same:
            raise SystemExit('FAIL: %s: card and CPU recode differ' % label)
    out = os.path.join(tmp, 'opt_profile.pdf')
    recode(out_pdf=out, device=DEV, profile_dir=os.path.join(tmp, 'sprof'),
           **base)
    with open(out, 'rb') as a, open(src, 'rb') as b:
        same = a.read() == b.read()
    print('  %-28s card: %s the run without it' % (
        '--profile', 'byte-identical with' if same else 'DIFFERENT from'))
    if not same:
        raise SystemExit('FAIL: --profile changed the PDF')


# a name each kernel's launches carry in a trace (csrc/*.cu; K3's first
# launch, as ``sauvola_kernel`` is also part of K4's name)
TRACE_NAMES = {'optimise': 'optimise_kernel', 'despeckle': 'despeckle_kernel',
               'blur_sauvola': 'blur_kernel',
               'line_sauvola': 'line_sauvola_kernel', 'paste': 'paste_kernel',
               'dwt97': 'dwt_level'}


def read_trace(path):
    """From a torch.profiler Chrome trace: the traced span (ms), the union
    of the CUDA kernel intervals in it (ms) and the kernel names."""
    with open(path) as fp:
        events = [e for e in json.load(fp)['traceEvents']
                  if e.get('ph') == 'X' and 'dur' in e]
    lo = min(e['ts'] for e in events)
    hi = max(e['ts'] + e['dur'] for e in events)
    kern = sorted((e['ts'], e['ts'] + e['dur']) for e in events
                  if e.get('cat') == 'kernel')
    busy, end = 0.0, -1e30
    for a, b in kern:
        if b > end:
            busy += b - max(a, end)
            end = b
    return (hi - lo) / 1e3, busy / 1e3, {e['name'] for e in events
                                         if e.get('cat') == 'kernel'}, \
        len(kern)


def phase_full_options(tmp, pages, wds, comp_ref):
    """3d: full-size runs of the options off the main path."""
    lined = dict(blur_sauvola=2, despeckle=2, optimise=4, line_sauvola=2,
                 paste=2)
    prof = os.path.join(tmp, 'prof')
    # pages 8-14 gray in batches of 4 and 3, page 15 RGB made gray alone
    run_book(tmp, 'grayprof', pages[8:], wds[8:],
             ['-J', 'tpu', '--grayscale-pdf', '--jbig2-symbol-coding',
              'auto', '--profile', prof],
             dict(lined, blur_sauvola=3, despeckle=3, optimise=6,
                  line_sauvola=3, paste=3, dwt97=6))
    trace = os.path.join(prof, 'trace.json')
    span, busy, names, n = read_trace(trace)
    print('  trace %s: %.1f MB, %d kernel events; device busy %.1f of '
          '%.1f ms traced = %.2f%% (the union of the CUDA kernel '
          'intervals; one run under the profiler)'
          % (trace, os.path.getsize(trace) / 1e6, n, busy, span,
             100 * busy / span))
    missing = [k for k, v in TRACE_NAMES.items()
               if not any(v in name for name in names)]
    if missing:
        raise SystemExit('FAIL: the trace names no kernel of %s' % missing)
    print('  the trace names K1-K5 and B7: %s' % ', '.join(
        sorted({name for name in names
                for v in TRACE_NAMES.values() if v in name})))

    launches = run_book(tmp, 'bwbreg', pages[:BATCH], wds[:BATCH],
                        ['--bw-pdf', '--denoise-mask', 'bregman'],
                        dict(blur_sauvola=2, line_sauvola=2, paste=2))
    if launches['optimise'] or launches['despeckle']:
        raise SystemExit('FAIL: --bw-pdf --denoise-mask bregman launched '
                         'the fill or the despeckle')

    from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import main
    src, hocr, insize = comp_ref['src']
    out = os.path.join(tmp, 'comp_card.pdf')
    print('phase 3d: compress-pdf-images with hOCR, 2 pages of %dx%d, one '
          'JPEG a page' % (H, W))
    t0 = time.time()
    rc, launches = _counted(lambda: main([src, hocr, out, '--dpi', str(DPI),
                                          '--device', DEV]))
    wall = time.time() - t0
    if rc != 0:
        raise SystemExit('FAIL: compress-pdf-images exited %d' % rc)
    for k, v in lined.items():
        if launches[k] < v:
            raise SystemExit('FAIL: compress-pdf-images launched %s %d '
                             'times, expected >= %d' % (k, launches[k], v))
    ours = _jbig2_masks(out)
    ref, cpu_s = comp_ref['cpu'].result()
    same = len(ours) == len(ref) == 2 and all(
        a.shape == b.shape and (a == b).all() for a, b in zip(ours, ref))
    print('  wall %.3f s (the --device cpu run %.1f s, on a thread); %d -> '
          '%d bytes; launches %s; masks %s the CPU run\'s'
          % (wall, cpu_s, insize, os.path.getsize(out), launches,
             'bit-equal with' if same else 'DIFFERENT from'))
    if not same:
        raise SystemExit('FAIL: compress-pdf-images masks differ from the '
                         'CPU run')


def _jpeg_pdf(tmp, pages, wds):
    """Pages as one JPEG a page, written by Pillow, and their hOCR."""
    from PIL import Image
    # Pillow's PDF writer looks its JPEG encoder up by name: registered
    # only once the plugin is imported
    from PIL import JpegImagePlugin  # noqa: F401
    src = os.path.join(tmp, 'comp_src.pdf')
    ims = [Image.fromarray(p) for p in pages]
    ims[0].save(src, save_all=True, append_images=ims[1:], resolution=DPI)
    return src, _write_hocr(tmp, 'comp', pages, wds), os.path.getsize(src)


def _cpu_compress(src, hocr, out):
    """compress-pdf-images --device cpu: phase 3d's reference masks."""
    from archive_pdf_tools_tpu_torch.cli.compress_pdf_images import main
    t = time.time()
    rc = main([src, hocr, out, '--dpi', str(DPI), '--device', 'cpu'])
    if rc != 0:
        raise SystemExit('FAIL: compress-pdf-images --device cpu exited %d'
                         % rc)
    return _jbig2_masks(out), time.time() - t


def phase_ablate(pages):
    """K6: each ablation build of K3 against its plain version at the
    main path's batch (book pages, real taps r=4); then the ablation
    tool's main at batch 2, whose launches are the ones counted."""
    import torch
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import threshold_ablate_cuda as A
    from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise
    from archive_pdf_tools_tpu_torch.tools import threshold_ablate
    gray = torch.from_numpy(np.stack(pages)).to(DEV)
    taps = D.blur_weights_from_sigma(estimate_noise(gray), 4).contiguous()
    print('phase 2c: K3 ablation builds vs plain, batch %d x %dx%d'
          % (len(pages), H, W))
    results = {}
    for v in A.VARIANTS:
        results[v] = _compare(
            'blur_sauvola_ablate %s' % v,
            lambda: A.blur_sauvola_ablate(gray, taps, WINDOW, v),
            lambda: A.blur_sauvola_ablate_plain(gray, taps, WINDOW, v),
            _nbytes((gray, taps)), _k3_ops(taps))
    del gray
    print('phase 2c: python -m archive_pdf_tools_tpu_torch.tools.'
          'threshold_ablate 2 1')
    A.blur_sauvola_ablate.launches.clear()
    rc = threshold_ablate.main(['2', '1'])
    launches = dict(A.blur_sauvola_ablate.launches)
    if rc != 0:
        raise SystemExit('FAIL: threshold_ablate exited %d' % rc)
    for v in A.VARIANTS:
        if launches.get(v, 0) < 1:
            raise SystemExit('FAIL: ablation build %s never launched' % v)
    return results, launches


def _slots_of(lines, sel):
    """The JAX step's line slots of ``RaggedLines`` and their selector:
    slot 0 the 1x1 dummy, then the lines in document order."""
    n = lines.n + 1
    boxes = np.zeros((4, n), np.int32)
    boxes[1, 0] = boxes[3, 0] = 1
    boxes[:, 1:] = lines.boxes.T
    pages = np.concatenate([[0], lines.pages]).astype(np.int32)
    return boxes, pages, np.concatenate([[0], sel]).astype(np.int32)


def _need_exactly(what, launches, want):
    got = {k: launches[k] for k in want}
    if got != want or launches['dwt97']:
        raise SystemExit('FAIL: %s launched %s, expected %s'
                         % (what, launches, want))


def phase_step(pages, wds, kernels):
    """2e: the fused step (mrc/step.py) on phase 2's batch, against the
    main path's bytes, its time beside K1-K5's, and split over two
    shards on the one card, then over the visible cards."""
    import torch
    from archive_pdf_tools_tpu_torch.mrc import api as TA
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.mrc.hocr_prep import prepare_lines
    from archive_pdf_tools_tpu_torch.mrc.step import mrc_full_step
    from archive_pdf_tools_tpu_torch.ops.lines_cuda import (
        RaggedLines, line_thresholds)
    from archive_pdf_tools_tpu_torch.parallel import mesh, sharded
    dev = torch.device(DEV)
    print('phase 2e: mrc_full_step, batch %d x %dx%d, window %d, against '
          'decompose_masks + decompose_layers' % (BATCH, H, W, WINDOW))
    mask, imgs = TA.decompose_masks(pages, wds, dpi=DPI, device=DEV)
    fg, bg = TA.decompose_layers(mask, imgs, device=True)
    lines = RaggedLines.from_page_boxes(
        [prepare_lines(wd, W, H) for wd in wds], H, W, dev)
    ct, ci, counts = line_thresholds(imgs, lines, WINDOW)
    sel = D.line_selector(ct, ci, counts, lines)
    del ct, ci
    boxes, spages, ssel = _slots_of(lines, sel)

    def step():
        return mrc_full_step(imgs, boxes, spages, ssel, WINDOW)

    out, launches = _counted(step)
    _need_exactly('mrc_full_step', launches, dict(
        blur_sauvola=1, line_sauvola=1, paste=1, despeckle=1, optimise=2))
    for what, got, ref in (('mask', out[0], mask), ('fg', out[1], fg),
                           ('bg', out[2], bg)):
        _check_equal('mrc_full_step %s vs the main path' % what, got, ref)
    ones, ones_inv = out[3]
    _check_equal('mrc_full_step line counts',
                 torch.stack([ones[1:], ones_inv[1:]], 1), counts)
    ms = _cuda_ms(step, 5)
    print('  == the main path (mask, fg, bg, %d line counts); launches %s; '
          '%.3f ms (CUDA events, median of 5)' % (lines.n, launches, ms))
    k_ms = None
    if kernels:
        parts = [kernels['line_sauvola'][0], kernels['blur_sauvola'][0],
                 kernels['paste'][0], kernels['despeckle'][0]] + \
            kernels['optimise'][1][:2]
        k_ms = sum(r['ms'] for r in parts)
        print('  beside K1-K5 %.3f ms (phase 2: K4 + K3 r=4 + K5 + K2 + K1 '
              'n=3 + K1 n=10)' % k_ms)

    def split_step(devices):
        sb, sp, ss = sharded.split_lines_per_shard(boxes, spages, ssel,
                                                   BATCH, len(devices))
        fn = sharded.sharded_mrc_step(devices, WINDOW)
        return lambda: fn(imgs, sb, sp, ss)

    two = split_step([dev, dev])
    got, launches = _counted(two)
    _need_exactly('sharded_mrc_step over [%s, %s]' % (DEV, DEV), launches,
                  dict(blur_sauvola=2, line_sauvola=2, paste=2, despeckle=2,
                       optimise=4))
    for what, g, r in zip(('mask', 'fg', 'bg'), got, out):
        _check_equal('two-shard step %s' % what, g, r)
    ms2 = _cuda_ms(two, 5)
    print('  sharded_mrc_step over [%s, %s] (2 shards of %d): == the '
          'one-device step; launches %s; %.3f ms (median of 5)'
          % (DEV, DEV, BATCH // 2, launches, ms2))
    n_dev = torch.cuda.device_count()
    print('  torch.cuda.device_count() = %d' % n_dev)
    if n_dev > 1:
        k = max(d for d in range(1, n_dev + 1) if BATCH % d == 0)
        cards = split_step(mesh.page_devices(k))
        for what, g, r in zip(('mask', 'fg', 'bg'), cards(), out):
            _check_equal('step over %d cards %s' % (k, what), g, r)
        print('  sharded_mrc_step over %d cards: == the one-device step; '
              '%.3f ms (median of 5)' % (k, _cuda_ms(cards, 5)))
    return {'ms': ms, 'k_ms': k_ms, 'two_ms': ms2}


def _gray_book(tmp):
    """Three noise-free gray 320x416 pages and their hOCR (phase 3e)."""
    from PIL import Image
    fx = _tests_module('fixtures')
    hocr = []
    for i in range(3):
        img, words = fx.render_book_page(320, 416, seed=10 + i, noise=0)
        Image.fromarray(img).save(os.path.join(tmp, 'gray_%04d.png' % i))
        hocr.append(fx.words_to_hocr_page(words, 320, 416, page_no=i,
                                          dpi=100))
    hocr_path = os.path.join(tmp, 'gray.hocr')
    with open(hocr_path, 'w', encoding='utf-8') as fp:
        fp.write(fx.HOCR_TEMPLATE % '\n'.join(hocr))
    return os.path.join(tmp, 'gray_*.png'), hocr_path


def _tool_outputs(tmp, src, device):
    """threshold-image (with the despeckle), partial-blur (the fill) and
    compress of the page ``src`` on ``device``: their output bytes."""
    from archive_pdf_tools_tpu_torch.tools import (compress, partial_blur,
                                                   threshold_image)
    tag = 'card' if device == DEV else 'cpu'
    mask = os.path.join(tmp, 'tool_mask_%s.png' % tag)
    blur = os.path.join(tmp, 'tool_fill_%s.png' % tag)
    pre = os.path.join(tmp, 'tool_%s' % tag)
    for mod, args in ((threshold_image, [src, mask, '--dpi', str(DPI),
                                         '--denoise', 'fast']),
                      (partial_blur, [src, mask, blur, '--mode',
                                      'optimise']),
                      (compress, [src, mask, pre])):
        if mod.main(args + ['--device', device]) != 0:
            raise SystemExit('FAIL: %s --device %s' % (mod.__name__, device))
    out = {}
    for name in (mask, blur, pre + '_fg.jp2', pre + '_bg.jp2'):
        with open(name, 'rb') as fp:
            out[os.path.basename(name).replace(tag, '*')] = fp.read()
    return out


def phase_split_and_tools(tmp, page):
    """3e: a recode split over two shards on the one card, the debug
    tools card against CPU, and the host CLIs."""
    import torch
    from archive_pdf_tools_tpu_torch import recode
    from archive_pdf_tools_tpu_torch.parallel import mesh
    from archive_pdf_tools_tpu_torch.pipeline import recode as R
    from PIL import Image
    os.environ['SOURCE_DATE_EPOCH'] = '1700000000'
    stack, hocr = _gray_book(tmp)
    print('phase 3e: 3-page gray book, batch 2, split over [%s, %s] '
          'against [%s]' % (DEV, DEV, DEV))
    for impl in ('pillow', 'tpu'):
        outs, runs = [], []
        for devices in ([DEV, DEV], [DEV]):
            outs.append(os.path.join(tmp, 'split%d_%s.pdf'
                                     % (len(devices), impl)))
            # the devices the pipeline takes from several visible cards
            R.default_devices = lambda device, d=devices: [
                torch.device(x) for x in d]
            try:
                _r, launches = _counted(lambda: recode(
                    from_imagestack=stack, hocr_file=hocr, out_pdf=outs[-1],
                    dpi=100, jbig2=True, batch_pages=2,
                    jpeg2000_implementation=impl, device=DEV))
            finally:
                R.default_devices = mesh.default_devices
            runs.append(launches)
        with open(outs[0], 'rb') as a, open(outs[1], 'rb') as b:
            same = a.read() == b.read()
        print('  -J %s: two shards %s the one-device run; K3 launches %d '
              '(2 shards + 1 page alone) and %d' % (
                  impl, 'byte-identical with' if same else 'DIFFERENT from',
                  runs[0]['blur_sauvola'], runs[1]['blur_sauvola']))
        if not same or runs[0]['blur_sauvola'] != 3 \
                or runs[1]['blur_sauvola'] != 2:
            raise SystemExit('FAIL: the two-shard recode (-J %s)' % impl)

    src = os.path.join(tmp, 'tool_page.png')
    Image.fromarray(page).save(src)
    print('phase 3e: threshold_image --denoise fast, partial_blur --mode '
          'optimise and compress on one %dx%d RGB page, card vs --device '
          'cpu' % (H, W))
    t0 = time.time()
    card, launches = _counted(lambda: _tool_outputs(tmp, src, DEV))
    t_card = time.time() - t0
    _need_exactly('the tools', launches, dict(
        blur_sauvola=1, despeckle=1, optimise=3, line_sauvola=0, paste=0))
    torch.set_num_threads(os.cpu_count() or 1)
    t0 = time.time()
    cpu = _tool_outputs(tmp, src, 'cpu')
    t_cpu = time.time() - t0
    for name, data in card.items():
        print('  %-22s %9d bytes, card %s CPU' % (
            name, len(data), '==' if data == cpu[name] else '!='))
        if data != cpu[name]:
            raise SystemExit('FAIL: %s differs between card and CPU' % name)
    print('  card %.1f s (launches %s), CPU %.1f s' % (t_card, launches,
                                                        t_cpu))

    # phase 3b's small book, its MRC PDF and hOCR
    pdf, hocr = (os.path.join(tmp, 'small_card.pdf'),
                 os.path.join(tmp, 'small.hocr'))
    for args in ([sys.executable, '-m',
                  'archive_pdf_tools_tpu_torch.tools.mrcview', pdf,
                  os.path.join(tmp, 'view.pdf')],
                 [sys.executable, '-m',
                  'archive_pdf_tools_tpu_torch.tools.pdfimagesmrc', pdf],
                 [sys.executable, os.path.join(ROOT, 'bin',
                                               'pdf-to-imagestack_torch'),
                  pdf, os.path.join(tmp, 'stack.zip')],
                 [sys.executable, os.path.join(ROOT, 'bin',
                                               'pdfrenderer_torch'),
                  '-T', hocr, '-o', os.path.join(tmp, 'text.pdf')]):
        r = subprocess.run(args, capture_output=True, text=True,
                           timeout=300, cwd=ROOT)
        name = os.path.basename(args[2 if args[1] == '-m' else 1])
        print('  %s: exit %d; %s' % (name, r.returncode,
                                     (r.stdout.strip().splitlines()
                                      or [''])[-1]))
        if r.returncode != 0:
            raise SystemExit('FAIL: %s exited %d: %s'
                             % (name, r.returncode, r.stderr[-500:]))


def phase_epub(tmp):
    """3f: epub-to-pdf_torch on tests/test_torch_epub.py's cases, each
    PDF held to the JAX converter's pinned sha256."""
    import importlib.util
    te = _tests_module('test_torch_epub')
    env = te.environment()
    have = ', '.join('%s %s' % (m, 'present' if importlib.util.find_spec(m)
                                else 'absent')
                     for m in ('lxml', 'matplotlib', 'fontTools'))
    print('phase 3f: epub-to-pdf_torch on %d cases (%s; pins: %s)'
          % (len(te.CASES), have, env))
    if env is None:
        raise SystemExit('FAIL: no pin for matplotlib without fontTools or '
                         'the reverse')
    t0 = time.time()
    for case in sorted(te.CASES):
        src = te.make_case(case, tmp)
        out = os.path.join(tmp, 'epub_%s.pdf' % case)
        r = subprocess.run([sys.executable, os.path.join(
            ROOT, 'bin', 'epub-to-pdf_torch'), src, out],
            capture_output=True, text=True, timeout=300, cwd=ROOT)
        if r.returncode != 0:
            raise SystemExit('FAIL: epub-to-pdf_torch on %s exited %d: %s'
                             % (case, r.returncode, r.stderr[-500:]))
        got, want = te.sha256_of(out), te.JAX_SHA256[case][env]
        print('  %-9s %s %s; %s' % (case, got, '== the JAX pin' if got ==
                                    want else '!= the JAX pin ' + want,
                                    r.stdout.strip().splitlines()[-1]))
        if got != want:
            raise SystemExit('FAIL: epub-to-pdf_torch on %s differs from '
                             'the JAX converter' % case)
    print('  phase 3f: %.3f s of wall time' % (time.time() - t0))


def _reader_times(path, reps=3):
    """Medians of ``reps`` alternating reads of the hOCR at ``path``:
    the port's ``hocr_page_iterator`` (each page yielded, cleared and
    its earlier siblings dropped), and stdlib ``ElementTree.iterparse``
    over the same bytes with the same page test and clearing (a
    yardstick, not a code path)."""
    import xml.etree.ElementTree as ET
    from archive_pdf_tools_tpu_torch.inputs import hocr

    def port():
        return sum(1 for _ in hocr.hocr_page_iterator(path))

    def stdlib():
        n = 0
        for _, el in ET.iterparse(path, events=('end',)):
            if el.tag.endswith('div') and \
                    (el.get('class') or '').strip() == 'ocr_page':
                n += 1
                el.clear()
        return n
    times = {'port': [], 'stdlib': []}
    pages = set()
    for _ in range(reps):
        for name, fn in (('stdlib', stdlib), ('port', port)):
            t0 = time.perf_counter()
            pages.add(fn())
            times[name].append(time.perf_counter() - t0)
    if len(pages) != 1:
        raise SystemExit('FAIL: the readers count different pages: %s'
                         % sorted(pages))
    return pages.pop(), {k: float(np.median(v)) for k, v in times.items()}


def phase_hocr(tmp, smi):
    """3g: hOCR that is not well-formed, read by the port's reader (a
    copy of the JAX one over ``utils/etree_compat.py``) on a machine
    without lxml: (a) ROADMAP C16's rows and the seeded mutated
    documents of ``tests/hocr_cases.py`` against the JAX reader's pins;
    (b) phase 3b's book with four C16 faults in its hOCR through
    recode_pdf_torch --hocr-file, card == CPU bytes, K1-K5 launched, the
    pinned words in its text layer; (c) the reader's time on phase 3's
    book hOCR and a generated 500-page one beside stdlib iterparse."""
    import importlib.util
    import io
    from archive_pdf_tools_tpu_torch.inputs import hocr
    from archive_pdf_tools_tpu_torch.pdf.textextract import pdf_to_hocr
    hc = _tests_module('hocr_cases')
    fx = hc._fixtures()
    t0 = time.time()
    docs = dict(hc.CASES)
    docs.update(('mutated_%03d' % k, hc.mutated(k))
                for k in range(hc.N_MUTATED))
    for name, data in docs.items():
        pages = hc.read(hocr, data)
        if hc.digest(pages) != hc.PINS[name]:
            raise SystemExit('FAIL: the hOCR reader differs from the JAX '
                             'reader on %s: %r' % (name, pages))
        if name in hc.PIN_WORDS and hc.words(pages) != hc.PIN_WORDS[name]:
            raise SystemExit('FAIL: the words of %s differ' % name)
    print('phase 3g: %d C16 rows and %d mutated hOCR documents read as the '
          'JAX reader (its pins; lxml %s here)' % (
              len(hc.CASES), hc.N_MUTATED, 'present' if
              importlib.util.find_spec('lxml') else 'absent'))

    # (b) the small book, its hOCR with four C16 faults
    words = [fx.render_book_page(320, 416, seed=i, rgb=i == 1, noise=0)[1]
             for i in range(3)]
    hocr_path = os.path.join(tmp, 'c16.hocr')
    with open(hocr_path, 'wb') as fp:
        fp.write(hc.book_hocr(words))
    stack = os.path.join(tmp, 'small_*.png')
    insize = sum(os.path.getsize(p) for p in glob.glob(stack))
    args = ['--from-imagestack', stack, '--hocr-file', hocr_path, '--dpi',
            '100']
    print('phase 3g: recode_pdf_torch --hocr-file on the 3-page small book, '
          'its hOCR with an undefined &nbsp;, a bare &, an unclosed <meta> '
          'and the file cut inside page 2')
    card = os.path.join(tmp, 'c16_card.pdf')
    _run_cli(args, card, insize, 3, dict(blur_sauvola=1, despeckle=1,
                                         optimise=2, line_sauvola=1,
                                         paste=1))
    cpu = os.path.join(tmp, 'c16_cpu.pdf')
    _run_cli(args, cpu, insize, 3, {}, device='cpu')
    with open(card, 'rb') as a, open(cpu, 'rb') as b:
        if a.read() != b.read():
            raise SystemExit('FAIL: card and CPU recode of the C16 book '
                             'differ')
    buf = io.BytesIO()
    pdf_to_hocr(card, buf)
    got = hc.words(hc.read(hocr, buf.getvalue()))
    if got != hc.PIN_WORDS['book']:
        raise SystemExit('FAIL: the text layer of the C16 book holds %r, '
                         'not the pinned words' % got)
    print('  card == CPU bytes; the text layer holds the JAX reader\'s '
          '%d words' % sum(map(len, got)))

    # (c) the reader's time on well-formed hOCR
    big = os.path.join(tmp, 'generated500.hocr')
    with open(big, 'w', encoding='utf-8') as fp:
        head, tail = fx.HOCR_TEMPLATE.split('%s')
        fp.write(head)
        for i in range(500):
            fp.write(fx.words_to_hocr_page(
                [(10 + 60 * w, 40 + 60 * ln, 50 + 60 * w, 80 + 60 * ln,
                  'word%d' % w) for ln in range(50) for w in range(8)],
                W, H, page_no=i, dpi=DPI) + '\n')
        fp.write(tail)
    print('phase 3g: hOCR reader vs stdlib ElementTree.iterparse (a '
          'yardstick), medians of 3, host clock, %s' % smi.strip())
    for path in (os.path.join(tmp, 'book.hocr'), big):
        n, t = _reader_times(path)
        print('  %s: %d pages, %.1f MB: port %.4f s, stdlib %.4f s, '
              'ratio %.3f' % (os.path.basename(path), n,
                              os.path.getsize(path) / 1e6, t['port'],
                              t['stdlib'], t['port'] / t['stdlib']))
    print('  phase 3g: %.3f s of wall time' % (time.time() - t0))


def phase_cards(pages, wds):
    """``--cards``: recode_pdf_torch -J tpu on the book with no
    --device, so a batch splits over every visible card, against
    --device cuda:0, in the order one, all, all, one; equal bytes."""
    import torch
    os.environ['SOURCE_DATE_EPOCH'] = '1700000000'
    n_dev = torch.cuda.device_count()
    print('phase cards: recode_pdf_torch -J tpu, %d pages of %dx%d, no '
          '--device (%d cards) against --device %s'
          % (len(pages), H, W, n_dev, DEV))
    with tempfile.TemporaryDirectory(prefix='chip_smoke') as tmp:
        glob_pat, hocr_path = _write_book(tmp, 'book', pages, wds)
        insize = sum(os.path.getsize(p) for p in glob.glob(glob_pat))
        outs, k3 = [], {}
        for i, device in enumerate((DEV, None, None, DEV)):
            print('  %s:' % (device or 'every card'))
            outs.append(os.path.join(tmp, 'cards%d.pdf' % i))
            launches = _run_cli(
                ['--from-imagestack', glob_pat, '--hocr-file', hocr_path,
                 '--dpi', str(DPI), '-J', 'tpu'], outs[-1], insize,
                len(pages), {}, device=device)
            k3[device] = launches['blur_sauvola']
        data = []
        for out in outs:
            with open(out, 'rb') as fp:
                data.append(fp.read())
    if any(d != data[0] for d in data):
        raise SystemExit('FAIL: the recode over every card differs from '
                         'the one-card run')
    print('  the four runs byte-identical; K3 launches %d over every card, '
          '%d on %s' % (k3[None], k3[DEV], DEV))
    if n_dev > 1 and k3[None] <= k3[DEV]:
        raise SystemExit('FAIL: no batch split over the cards')


def main_cards():
    """``python3 chip_smoke.py --cards``: on a host with several cards,
    the step and a recode split over all of them against one card."""
    import torch
    smi = phase_build()
    book = make_pages()
    pages = [p for p, _ in book]
    wds = [wd for _, wd in book]
    phase_step(pages[:BATCH], wds[:BATCH], None)
    phase_cards(pages, wds)
    print(smi)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    if sys.argv[1:] == ['--cards']:
        return main_cards()
    t_start = time.time()
    smi = phase_build()
    t0 = time.time()
    book = make_pages()
    pages = [p for p, _ in book]
    wds = [wd for _, wd in book]
    print('made %d pages in %.1f s' % (N_PAGES, time.time() - t0))
    tmp_ref = tempfile.TemporaryDirectory(prefix='chip_smoke_ref')
    comp_src = _jpeg_pdf(tmp_ref.name, pages[:2], wds[:2])
    # the CPU forms phases 2d and 3d compare with, on a thread while the
    # card runs phases 2-2c; what the thread imports is imported
    # here first (an import racing another thread's can leave Pillow
    # without a plugin)
    from PIL import Image
    Image.init()
    import archive_pdf_tools_tpu_torch.cli.compress_pdf_images  # noqa: F401
    import archive_pdf_tools_tpu_torch.ops.tv  # noqa: F401
    import archive_pdf_tools_tpu_torch.pdf.raster  # noqa: F401
    import archive_pdf_tools_tpu_torch.pipeline.recode  # noqa: F401
    # one worker, the TV last: phase 2d waits for it, so neither reference
    # is still running in phase 3, whose host-bound runs it would slow
    refs = ThreadPoolExecutor(max_workers=1, initializer=_leave_two_cores)
    comp_ref = {'src': comp_src, 'cpu': refs.submit(
        _cpu_compress, comp_src[0], comp_src[1],
        os.path.join(tmp_ref.name, 'comp_cpu.pdf'))}
    tv_ref = refs.submit(_cpu_tv_reference, pages[0])
    kernels = phase_kernels(pages[:BATCH], wds[:BATCH])
    phase_odd_shapes()
    ablate, ablate_launches = phase_ablate(pages[:BATCH])
    t_step = time.time()
    step = phase_step(pages[:BATCH], wds[:BATCH], kernels)
    t_step = time.time() - t_step
    t_new = time.time()
    phase_offpath_ops(pages, tv_ref)
    t_new = time.time() - t_new
    every = {'blur_sauvola': 2, 'despeckle': 2, 'optimise': 4}
    lined = dict(every, line_sauvola=2, paste=2)
    with tempfile.TemporaryDirectory(prefix='chip_smoke') as tmp:
        launches = run_book(tmp, 'book', pages, wds, [], lined)
        run_book(tmp, 'bgds', pages, wds, ['--bg-downsample', '3'], lined)
        # -J tpu with page 3 HQ: the batch transform of the other pages'
        # layers (fg in groups of 4), the HQ page's layers alone
        tpu = run_book(tmp, 'tpu', pages, wds, ['-J', 'tpu', '--hq-pages',
                                                '3'], dict(lined, dwt97=8))
        check_jpx(os.path.join(tmp, 'tpu.pdf'))
        launches['dwt97'] = tpu['dwt97']
        run_book(tmp, 'noword', pages[:BATCH], [[]] * BATCH, [],
                 dict(every, blur_sauvola=1, despeckle=1, optimise=2))
        # at least one batch with lines: each kernel once, K1 twice
        one_batch = dict(blur_sauvola=1, despeckle=1, optimise=2,
                         line_sauvola=1, paste=1)
        phase_from_pdf(tmp, pages[:BATCH], wds[:BATCH], one_batch)
        phase_small_book(tmp)
        phase_small_from_pdf(tmp, one_batch)
        phase_scandata(tmp, one_batch)
        t0 = time.time()
        print('phase 3d: the recode options off the main path on the '
              '3-page small book, card vs CPU plain path')
        phase_small_options(tmp)
        phase_full_options(tmp, pages, wds, comp_ref)
        t_new += time.time() - t0
        t0 = time.time()
        phase_split_and_tools(tmp, pages[N_PAGES - 1])
        t_step += time.time() - t0
        phase_epub(tmp)
        phase_hocr(tmp, smi)
    refs.shutdown()
    tmp_ref.cleanup()
    print('phases 2d and 3d: %.1f s of wall time (their CPU references ran '
          'on a thread from phase 2 on)' % t_new)
    print('phases 2e and 3e: %.1f s of wall time; the step %.3f ms, two '
          'shards %.3f ms, K1-K5 %.3f ms' % (t_step, step['ms'],
                                             step['two_ms'], step['k_ms']))
    if 'jax' in sys.modules:
        raise SystemExit('FAIL: jax was imported')

    summary = []
    for name, (head, cases) in kernels.items():
        summary.append({
            'name': name, 'route': 'cuda',
            'source': 'archive_pdf_tools_tpu_torch/csrc/%s.cu' % name,
            'replaces': KERNELS[name][2], 'launches': launches[name],
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': head['ms'], 'plain_ms': head['plain_ms'],
            'bound_ms': head['bound_ms'], 'bound_by': head['bound_by'],
            'library_ms': None})
    for v, r in ablate.items():
        summary.append({
            'name': 'blur_sauvola_ablate.' + v, 'route': 'cuda',
            'source': 'archive_pdf_tools_tpu_torch/csrc/blur_sauvola.cu',
            'replaces': ABLATE, 'launches': ablate_launches[v],
            'max_abs_err': r['max_abs_err'], 'ms': r['ms'],
            'plain_ms': r['plain_ms'], 'bound_ms': r['bound_ms'],
            'bound_by': r['bound_by'], 'library_ms': None})
    print('chip_smoke wall time: %.1f s' % (time.time() - t_start))
    print(smi)
    print(json.dumps({'kernels': summary}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
