#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (archive_pdf_tools_tpu_torch) on
one NVIDIA GPU: ``python3 chip_smoke.py`` from the repository root.

Phases, in order; any failure ends the run with a non-zero exit:

1. Device and build: the card's name and power limit, and the nvcc build
   of the three kernels (``archive_pdf_tools_tpu_torch/csrc``).
2. Kernel vs plain version, on the card, at the main path's shapes (a
   batch of 8 gray 400-DPI pages, 3300x2550; RGB for the fill): each
   kernel must equal its plain PyTorch version bit for bit.  Times are
   medians of CUDA-event-timed runs after a warm-up.  Then the same
   check at small and ragged shapes.
3. End to end: a 16-page 400-DPI book whose hOCR holds no words goes
   through the recode_pdf_torch CLI with default flags (two batches of
   8); the output must pass the PDF/A validator and every kernel must
   have launched.  A small book recoded on the card must also equal,
   byte for byte, the same book recoded with the plain versions on the
   CPU.

The line before the last is the kernels' JSON summary; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA device the run exits
1 and prints no result.
"""

import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
H, W, DPI, BATCH, N_PAGES = 3300, 2550, 400, 8, 16


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


def _compare(name, kernel_fn, plain_fn):
    """Kernel vs plain on the same inputs: bit-exact, with both times."""
    import torch
    got = kernel_fn()                    # warm-up + result
    ref = plain_fn()
    torch.cuda.synchronize()
    err = int((got.to(torch.int32) - ref.to(torch.int32)).abs().max())
    ms = _cuda_ms(kernel_fn, 5)
    plain_ms = _cuda_ms(plain_fn, 2)
    print('  %-34s max_abs_err=%d  kernel %.3f ms  plain %.3f ms'
          % (name, err, ms, plain_ms))
    if err != 0:
        raise SystemExit('FAIL: %s differs from its plain version' % name)
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms}


def _tests_module(name):
    """tests/<name>.py loaded by path (an installed package may own the
    top-level name 'tests')."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        'chip_smoke_' + name, os.path.join(ROOT, 'tests', name + '.py'))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def make_pages(n):
    """n synthetic 400-DPI gray book pages, deterministic in the seed."""
    synth_scan = _tests_module('scanfix').synth_scan
    return [synth_scan(h=H, w=W, seed=i, dpi=DPI, fast_paper=True)[0]
            for i in range(n)]


def phase_build():
    import torch
    from archive_pdf_tools_tpu_torch.utils import cudabuild
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda)
    print('device:', torch.cuda.get_device_name(0))
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    print('nvidia-smi:', smi)
    print('torch', torch.__version__, 'cuda', torch.version.cuda)
    for name, mod in (('optimise', optimise_cuda),
                      ('despeckle', denoise_cuda),
                      ('blur_sauvola', threshold_cuda)):
        cudabuild.load(name, mod._SIGNATURES)
        info = cudabuild.BUILD_INFO[name]
        print('nvcc build %s: %.2f s' % (name, info['seconds']))
        for line in info['log'].splitlines():
            if 'registers' in line or 'spill' in line:
                print('   ', line.strip())
    return smi


def phase_kernels(pages):
    import torch
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda)
    from archive_pdf_tools_tpu_torch.ops.optimise import optimise as opt_plain
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_exact as den_plain
    from archive_pdf_tools_tpu_torch.ops.sigma import estimate_noise

    dev = torch.device('cuda:0')
    window = 101                         # sauvola_window(400)
    gray = torch.from_numpy(np.stack(pages[:BATCH])).to(dev)
    rng = np.random.default_rng(1234)
    noisy_np = np.clip(np.stack(pages[:BATCH]).astype(np.float32)
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
            name, lambda: threshold_cuda.blur_sauvola(img, taps, window),
            lambda: threshold_cuda.blur_sauvola_plain(img, taps, window)))
    results['blur_sauvola'] = (k3[1], k3)

    mask = threshold_cuda.blur_sauvola(gray, cases[1][2], window)
    r = _compare('despeckle (sauvola mask)',
                 lambda: denoise_cuda.fast_mask_denoise(mask, 4, 2),
                 lambda: den_plain(mask, 4, 2))
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
                           lambda: opt_plain(m, img, n)))
    results['optimise'] = (k1[1], k1)
    return results


def phase_odd_shapes():
    """Kernel == plain at small and ragged shapes: windows and blur
    radii larger than the page, widths under one warp, odd batches."""
    import torch
    from archive_pdf_tools_tpu_torch.mrc import decompose as D
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda)
    from archive_pdf_tools_tpu_torch.ops.optimise import optimise as opt_plain
    from archive_pdf_tools_tpu_torch.ops.denoise import \
        fast_mask_denoise_exact as den_plain
    dev = torch.device('cuda:0')
    rng = np.random.default_rng(99)
    n_cases = 0
    for b, h, w in ((1, 1, 1), (2, 5, 7), (1, 40, 33), (3, 97, 301),
                    (2, 300, 1030)):
        img = torch.from_numpy(rng.integers(0, 256, (b, h, w),
                                            dtype=np.uint8)).to(dev)
        sig = torch.from_numpy(rng.uniform(8, 40, b).astype(np.float32))
        for r, window in ((4, 31), (16, 101)):
            taps = D.blur_weights_from_sigma(sig.to(dev), r).contiguous()
            got = threshold_cuda.blur_sauvola(img, taps, window)
            ref = threshold_cuda.blur_sauvola_plain(img, taps, window)
            n_cases += 1
            if not torch.equal(got, ref):
                raise SystemExit('FAIL: blur_sauvola differs at %s r=%d'
                                 % ((b, h, w), r))
        mask = torch.from_numpy(rng.random((b, h, w)) < 0.3).to(dev)
        if not torch.equal(denoise_cuda.fast_mask_denoise(mask, 4, 2),
                           den_plain(mask, 4, 2)):
            raise SystemExit('FAIL: despeckle differs at %s' % ((b, h, w),))
        rgb = torch.from_numpy(rng.integers(0, 256, (b, h, w, 3),
                                            dtype=np.uint8)).to(dev)
        for im in (img, rgb):
            for m, n in ((mask, 3), (~mask, 10)):
                if not torch.equal(optimise_cuda.optimise(m, im, n),
                                   opt_plain(m, im, n)):
                    raise SystemExit('FAIL: optimise differs at %s n=%d'
                                     % (tuple(im.shape), n))
        n_cases += 5
    torch.cuda.synchronize()
    print('phase 2b: %d odd-shape cases, kernel == plain' % n_cases)


def _write_book(tmp, pages):
    from PIL import Image
    fx = _tests_module('fixtures')
    hocr = []
    for i, page in enumerate(pages):
        Image.fromarray(page).save(os.path.join(tmp, 'page_%04d.png' % i))
        hocr.append(fx.words_to_hocr_page([], page.shape[1], page.shape[0],
                                          page_no=i, dpi=DPI))
    hocr_path = os.path.join(tmp, 'book.hocr')
    with open(hocr_path, 'w', encoding='utf-8') as fp:
        fp.write(fx.HOCR_TEMPLATE % '\n'.join(hocr))
    return os.path.join(tmp, 'page_*.png'), hocr_path


def phase_e2e(pages, tmp):
    from archive_pdf_tools_tpu.validators import validate_pdfa  # jax-free
    from archive_pdf_tools_tpu_torch.cli.recode_pdf import main
    from archive_pdf_tools_tpu_torch.ops import (optimise_cuda, denoise_cuda,
                                                 threshold_cuda)
    glob_pat, hocr_path = _write_book(tmp, pages)
    out = os.path.join(tmp, 'book.pdf')
    counters = {'blur_sauvola': threshold_cuda.blur_sauvola,
                'despeckle': denoise_cuda.fast_mask_denoise,
                'optimise': optimise_cuda.optimise}
    print('phase 3: recode_pdf_torch, %d pages of %dx%d at %d DPI'
          % (len(pages), H, W, DPI))
    for fn in counters.values():
        fn.launches = 0
    t0 = time.time()
    rc = main(['--from-imagestack', glob_pat, '--hocr-file', hocr_path,
               '--dpi', str(DPI), '-o', out, '-v'])
    wall = time.time() - t0
    launches = {k: fn.launches for k, fn in counters.items()}
    if rc != 0:
        raise SystemExit('FAIL: recode_pdf_torch exited %d' % rc)
    validate_pdfa(out)
    insize = sum(os.path.getsize(p) for p in glob.glob(glob_pat))
    print('  wall %.3f s = %.4f pages/s; compression ratio %.3f; '
          'PDF/A valid; launches %s'
          % (wall, len(pages) / wall, insize / os.path.getsize(out),
             launches))
    need = {'blur_sauvola': 2, 'despeckle': 2, 'optimise': 4}
    for k, n in need.items():
        if launches[k] < n:
            raise SystemExit('FAIL: %s launched %d times on the main path, '
                             'expected >= %d' % (k, launches[k], n))
    return launches


def phase_small_book(tmp):
    """The card and the CPU's plain versions give the same PDF bytes on
    noise-free pages (identity blur taps: float exp and sum order, which
    may differ between CPU and GPU libraries, never enter)."""
    from PIL import Image
    from archive_pdf_tools_tpu_torch import recode
    fx = _tests_module('fixtures')
    os.environ['SOURCE_DATE_EPOCH'] = '1700000000'
    hocr = []
    for i in range(3):
        img, _ = fx.render_book_page(320, 416, seed=i, rgb=i == 1, noise=0)
        Image.fromarray(img).save(os.path.join(tmp, 'small_%04d.png' % i))
        hocr.append(fx.words_to_hocr_page([], 320, 416, page_no=i, dpi=100))
    hocr_path = os.path.join(tmp, 'small.hocr')
    with open(hocr_path, 'w', encoding='utf-8') as fp:
        fp.write(fx.HOCR_TEMPLATE % '\n'.join(hocr))
    outs = {}
    for dev in ('cuda:0', 'cpu'):
        outs[dev] = os.path.join(tmp, 'small_%s.pdf' % dev.split(':')[0])
        recode(from_imagestack=os.path.join(tmp, 'small_*.png'),
               hocr_file=hocr_path, out_pdf=outs[dev], dpi=100, jbig2=True,
               device=dev)
    with open(outs['cuda:0'], 'rb') as a, open(outs['cpu'], 'rb') as b:
        same = a.read() == b.read()
    print('phase 3b: 3-page noise-free book, card vs CPU plain path: %s'
          % ('byte-identical' if same else 'DIFFERENT'))
    if not same:
        raise SystemExit('FAIL: card and CPU recode differ')


def main():
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: torch.cuda.is_available() is false',
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    smi = phase_build()
    t0 = time.time()
    pages = make_pages(N_PAGES)
    print('made %d pages in %.1f s' % (N_PAGES, time.time() - t0))
    kernels = phase_kernels(pages)
    phase_odd_shapes()
    with tempfile.TemporaryDirectory(prefix='chip_smoke') as tmp:
        launches = phase_e2e(pages, tmp)
        phase_small_book(tmp)
    if 'jax' in sys.modules:
        raise SystemExit('FAIL: jax was imported')

    src = {'optimise': ('archive_pdf_tools_tpu_torch/csrc/optimise.cu',
                        'archive_pdf_tools_tpu/ops/optimise_pallas.py:232'),
           'despeckle': ('archive_pdf_tools_tpu_torch/csrc/despeckle.cu',
                         'archive_pdf_tools_tpu/ops/denoise_pallas.py:349'),
           'blur_sauvola': ('archive_pdf_tools_tpu_torch/csrc/'
                            'blur_sauvola.cu',
                            'archive_pdf_tools_tpu/ops/threshold_pallas.py'
                            ':233')}
    summary = []
    for name, (head, cases) in kernels.items():
        summary.append({
            'name': name, 'route': 'cuda', 'source': src[name][0],
            'replaces': src[name][1], 'launches': launches[name],
            'max_abs_err': max(c['max_abs_err'] for c in cases),
            'ms': head['ms'], 'plain_ms': head['plain_ms']})
    print(smi)
    print(json.dumps({'kernels': summary}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
