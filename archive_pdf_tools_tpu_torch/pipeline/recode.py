"""recode(): the end-to-end document pipeline on torch tensors.

Counterpart of the JAX package's ``pipeline/recode.py``, option for
option: an image stack or an existing PDF (``from_pdf``) plus hOCR.
Pass 1 writes one invisible-text page per hOCR page.  Pass 2, in MRC
mode, groups the pages into batches of equal shape/mode/dpi on a loader
thread, runs the MRC decomposition of each batch on the device
(``mrc/api.py``; ``--grayscale-pdf`` converts RGB batches there first),
encodes mask/fg/bg on a host thread pool while the next batch computes
(JBIG2 generic, symbol-coded or in bands; JPEG2000 through Pillow or the
in-tree encoder, ``-J tpu``, whose transform runs on the device), and
inserts the encoded streams in page order, so xref numbering (and the
output bytes) never depend on thread completion order.  ``--bw-pdf``
inserts each page's inverted mask alone; image modes 0 and 1 pass a
source PDF's images through or re-encode its rendered pages; with
``profile_dir`` pass 2 runs under ``torch.profiler``.  The PDF names
this engine (``PRODUCER``) in Info and XMP.
"""

import io
import json
import os
import queue
import sys
import threading
from concurrent.futures import ThreadPoolExecutor
from glob import glob
from time import time
from xml.sax.saxutils import escape as xmlescape

import numpy as np
import torch
from PIL import Image

from ..codecs.jp2tpu import transform_jp2_batch_async
from ..codecs.jpeg2000 import (decode_jpeg2000, get_jpeg2000_info,
                               _pillow_kwargs, DEFAULT_COMPRESSION_FLAGS,
                               DEFAULT_JPEG_FLAGS)
from ..codecs.mrc_encode import (encode_mrc_images, encode_mrc_mask,
                                 EncodedLayer, EncodedMask, PackedMask)
from ..const import (
    IMAGE_MODE_PASSTHROUGH, IMAGE_MODE_PIXMAP, IMAGE_MODE_MRC,
    COMPRESSOR_JPEG2000, COMPRESSOR_JPEG, COMPRESSOR_JBIG2, COMPRESSOR_CCITT,
    JPEG2000_IMPL_PILLOW, JPEG2000_IMPL_TPU, DENOISE_FAST,
    RECODE_RUNTIME_WARNING_INVALID_PAGE_SIZE, REFERENCE_PRODUCER)
from ..inputs.hocr import (hocr_page_iterator, hocr_page_to_word_data,
                           hocr_page_get_dimensions, hocr_page_get_scan_res)
from ..inputs.scandata import Scandata
from ..mrc.api import decompose_masks, decompose_layers
from ..ops.grayconvert import special_gray_convert
from ..pdf.builder import DocumentBuilder
from ..pdf.reader import PdfReader
from ..pdf.writer import Name
from ..pipeline.timing import get_timing_summary, Reporter
from ..utils.backend import (pack_mask_bits, resolve_device, synchronize,
                             unpack_mask_bits)

PDFA_MIN_UNITS = 3
PDFA_MAX_UNITS = 14400

Image.MAX_IMAGE_PIXELS = 625000000

DEFAULT_BATCH_PAGES = 8

# -J tpu transforms a batch's fg layers in groups of this many pages, so
# that one group's host Tier-1 can start while the next group is still
# being copied back (the JAX package's APT_JP2_XFORM_GROUP default)
JP2_FG_GROUP = 4


def _jp2_transform_args(flags):
    """transform_jp2_batch_async arguments from a -J tpu flag string
    (``ratio:500;levels:5;delta:0.5``): pack8 at ratio >= 200, as the JAX
    pipeline asks (pack4 from 400 is the transform's own choice)."""
    kw = _pillow_kwargs(flags[0]) if flags and flags[0] else {}
    ratio = kw.get('ratio')
    return dict(base_delta=kw.get('delta', 1.0 / 64),
                levels=int(kw.get('levels', 5)),
                pack8=bool(ratio) and float(ratio) >= 200, ratio=ratio)


def guess_dpi(w, h, expected_format=(8.27, 11.69),
              round_to=(72, 96, 150, 300, 600)):
    """Best-matching DPI against an expected physical page size
    (``recode.py:62-84``)."""
    w_dpi = w / expected_format[0]
    h_dpi = h / expected_format[1]
    return min(round_to, key=lambda dpi: abs(w_dpi - dpi) + abs(h_dpi - dpi))


def _page_geometry(imwidth, imheight, page_dpi, per_page_dpi, doc_dpi,
                   verbose, errors):
    """Page-size / DPI fallback policy (``recode.py:145-203``)."""
    if page_dpi is None:
        page_dpi = guess_dpi(imwidth, imheight)
    page_width = imwidth / (page_dpi / 72)
    if page_width <= PDFA_MIN_UNITS or page_width >= PDFA_MAX_UNITS:
        if verbose:
            print('Page size invalid with current image size and dpi.')
            print('Image size: %d, %d. DPI: %d' % (imwidth, imheight,
                                                   page_dpi))
        if per_page_dpi is not None and doc_dpi:
            page_width = imwidth / (doc_dpi / 72)
        if page_width <= PDFA_MIN_UNITS or page_width >= PDFA_MAX_UNITS:
            page_dpi = guess_dpi(imwidth, imheight)
            page_width = imwidth / (page_dpi / 72)
        if page_width <= PDFA_MIN_UNITS or page_width >= PDFA_MAX_UNITS:
            page_width = PDFA_MIN_UNITS + 1
        if errors is not None:
            errors.add(RECODE_RUNTIME_WARNING_INVALID_PAGE_SIZE)
    scaler = page_width / imwidth
    ppi = 72.0 / scaler
    return page_width, imheight * scaler, ppi


def create_text_pages(builder, hocr_file, in_pdf=None, image_files=None,
                      dpi=None, skip_pages=None, dpi_pages=None,
                      reporter=None, verbose=False, stop_after=None,
                      jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                      errors=None):
    """Pass 1 (``recode.py:87-234``): one invisible-text page per hOCR
    page, honoring input-PDF page sizes or image dims + DPI policy."""
    skipped_pages = 0
    count = 0
    t0 = time()
    for idx, hocr_page in enumerate(hocr_page_iterator(hocr_file)):
        w, h = hocr_page_get_dimensions(hocr_page)
        hocr_dpi = hocr_page_get_scan_res(hocr_page)[1]

        if skip_pages and idx in skip_pages:
            skipped_pages += 1
            continue
        if stop_after is not None and (idx - skipped_pages) >= stop_after:
            break

        if in_pdf is not None:
            width, height = in_pdf.page_size(idx - skipped_pages)
            scaler = width / w
            ppi = 72 / scaler
        elif image_files is not None:
            imgfile = image_files[idx]   # do not subtract skipped pages
            if imgfile.endswith('.jp2'):
                size, _ = get_jpeg2000_info(
                    imgfile, jpeg2000_implementation, errors)
                imwidth, imheight = size
            else:
                with Image.open(imgfile) as img:
                    imwidth, imheight = img.size

            page_dpi = dpi
            per_page_dpi = None
            if dpi_pages is not None:
                try:
                    per_page_dpi = int(dpi_pages[idx - skipped_pages])
                    page_dpi = per_page_dpi
                except (TypeError, ValueError, IndexError):
                    pass
            width, height, ppi = _page_geometry(
                imwidth, imheight, page_dpi, per_page_dpi, dpi,
                verbose, errors)
        else:
            raise ValueError('need in_pdf or image_files')

        if hocr_dpi is not None:
            font_scaler = hocr_dpi / ppi
        else:
            font_scaler = 72.0 / ppi

        word_data = hocr_page_to_word_data(hocr_page, font_scaler)
        builder.add_text_page(word_data, width, height, ppi=ppi,
                              hocr_ppi=hocr_dpi)
        count += 1

    if reporter and count:
        ms = int(((time() - t0) / count) * 1000)
        reporter.send({'text_pages': {'count': count, 'time-per': ms}})
    return count


def _decode_pdf_image(reader, stream):
    """Decode a page image XObject to PIL (``recode.py:323-332`` uses
    PyMuPDF extract_image; we decode per filter: DCT/JPX via Pillow,
    JBIG2 via the in-tree decoder, CCITT G4 via libtiff, Flate raw)."""
    raw, filt, w, h, cs = reader.extract_image(stream)
    if filt in ('DCTDecode', 'JPXDecode', None) or filt is None:
        try:
            image = Image.open(io.BytesIO(raw))
            image.load()
            return image
        except Exception:
            pass
    if filt == 'JBIG2Decode':
        from ..codecs.jbig2 import decode_jbig2
        bits = decode_jbig2(raw, w, h)
        # jbig2 white (0) = ink-opaque; a /Decode [1 0] array (symbol-
        # coded masks store ink as jbig2 black) flips the polarity
        dec = reader.resolve(stream.dict.get('Decode'))
        if dec and float(reader.resolve(dec[0])) == 1.0:
            return Image.fromarray(bits)
        return Image.fromarray(~bits)
    if filt == 'CCITTFaxDecode':
        # sample bits per /K //EncodedByteAlign //BlackIs1 (foreign G3
        # faxes and default-polarity G4 both appear in the wild; our
        # own masks carry /BlackIs1 true so nothing changes for them)
        from ..codecs.ccitt import decode_ccitt, pdf_fax_params
        k, ba, b1 = pdf_fax_params(reader.resolve, stream.dict)
        bits = decode_ccitt(raw, w, h, k=k, byte_align=ba,
                            black_is_1=b1)
        dec = reader.resolve(stream.dict.get('Decode'))
        if dec and float(reader.resolve(dec[0])) == 1.0:
            bits = ~bits
        return Image.fromarray(bits)
    # FlateDecode or already-decoded raw samples
    data = stream.decoded()
    bpc = reader.resolve(stream.dict.get('BitsPerComponent')) or 8
    if bpc == 8 and cs == 'DeviceRGB' and len(data) >= w * h * 3:
        arr = np.frombuffer(data[:w * h * 3], np.uint8).reshape(h, w, 3)
        return Image.fromarray(arr)
    if bpc == 8 and len(data) >= w * h:
        arr = np.frombuffer(data[:w * h], np.uint8).reshape(h, w)
        return Image.fromarray(arr)
    if bpc == 1:
        stride = (w + 7) // 8
        arr = np.unpackbits(
            np.frombuffer(data[:stride * h], np.uint8).reshape(h, stride),
            axis=1)[:, :w]
        return Image.fromarray(arr.astype(bool))
    raise ValueError('cannot decode page image (filter %r)' % (filt,))


def _render_page_composite(reader, idx):
    """A whole page (all images and vector/text marks) rendered at the
    resolution of its largest image, 'L' or 'RGB' as the MRC takes it:
    multi-image pages and image mode 1."""
    from ..pdf.raster import render_page_image
    img = render_page_image(reader, idx)
    return img.convert('L') if img.mode == '1' else img


class PageJob:
    __slots__ = ('page_idx', 'src_idx', 'word_data', 'dpi', 'hq')

    def __init__(self, page_idx, src_idx, word_data, dpi, hq):
        self.page_idx = page_idx
        self.src_idx = src_idx
        self.word_data = word_data
        self.dpi = dpi
        self.hq = hq


def _load_page_image(in_pdf, image_files, src_idx, downsample,
                     jpeg2000_implementation, threads, debug, timing_data):
    """Image load policy (``recode.py:318-372``): a source PDF page's one
    image decoded, or a multi-image page rendered whole; an image-stack
    file read.  ``--downsample`` reduces JPEG2000 files in the decoder
    and shrinks other pages with a LANCZOS thumbnail on the host."""
    t = time()
    downsampled = False
    if in_pdf is not None:
        imgs = in_pdf.page_images(src_idx)
        if not imgs:
            raise ValueError('page %d has no images' % src_idx)
        if len(imgs) == 1:
            _, _, stream = imgs[0]
            image = _decode_pdf_image(in_pdf, stream)
        else:
            image = _render_page_composite(in_pdf, src_idx)
    else:
        imgfile = image_files[src_idx]
        if imgfile.endswith(('.jp2', '.jpx')):
            image = decode_jpeg2000(imgfile, reduce_=downsample,
                                    impl=jpeg2000_implementation,
                                    threads=threads, debug=debug)
            downsampled = bool(downsample)
        else:
            image = Image.open(imgfile)
            image.load()
        if image.mode == 'RGBA':
            image = image.convert('RGB')
        elif image.mode == 'LA':
            image = image.convert('L')
    if timing_data is not None:
        timing_data.append(('image_load', time() - t))

    if downsample is not None and not downsampled:
        w, h = image.size
        image.thumbnail((w / downsample, h / downsample),
                        resample=Image.LANCZOS, reducing_gap=None)
    return image


class _TimingSink:
    """Thread-safe (stage, seconds) accumulator with atomic drain: encode
    workers append while the main thread drains a --report-every
    window, and late appends land in the next window."""

    def __init__(self):
        self._items = []
        self._lock = threading.Lock()

    def append(self, item):
        with self._lock:
            self._items.append(item)

    def drain(self):
        with self._lock:
            out = self._items
            self._items = []
        return out

    def snapshot(self):
        with self._lock:
            return list(self._items)

    def __bool__(self):
        return bool(self.snapshot())

    def __iter__(self):
        return iter(self.snapshot())


def _resume_jobs(builder, jobs, img_dir, mask_fmt, verbose):
    """Splice pages whose --out-dir artifacts exist straight from disk;
    returns the jobs still to compute."""
    remaining = []
    ext = {'jbig2': 'jbig2', 'ccitt': 'g4', 'png': 'png'}[mask_fmt]
    for job in jobs:
        meta_path = os.path.join(img_dir, '%.6d_meta.json' % job.page_idx)
        paths = [os.path.join(img_dir, '%.6d_%s' % (job.page_idx, sfx))
                 for sfx in ('mask.' + ext, 'bg.jp2', 'fg.jp2')]
        if not (os.path.exists(meta_path)
                and all(os.path.exists(p) for p in paths)):
            remaining.append(job)
            continue
        with open(meta_path) as fp:
            meta = json.load(fp)
        with open(paths[0], 'rb') as fp:
            mdec = meta.get('mask_decode')
            em = EncodedMask(fp.read(), meta['mask'][2], meta['mask'][0],
                             meta['mask'][1], tuple(mdec) if mdec else None)
        with open(paths[1], 'rb') as fp:
            eb = EncodedLayer(fp.read(), meta['bg'][2], meta['bg'][0],
                              meta['bg'][1], meta['gray'])
        with open(paths[2], 'rb') as fp:
            ef = EncodedLayer(fp.read(), meta['fg'][2], meta['fg'][0],
                              meta['fg'][1], meta['gray'])
        builder.insert_image(job.page_idx, eb, gray=meta['gray'])
        builder.insert_image(job.page_idx, ef, gray=meta['gray'],
                             mask_enc=em)
    if verbose and len(remaining) != len(jobs):
        print('Resumed %d pages from %s' % (len(jobs) - len(remaining),
                                            img_dir))
    return remaining


def _write_artifacts(img_dir, job, image_mode, em, eb, ef):
    """Per-page --out-dir files plus the sidecar that makes the page
    resumable (--resume)."""
    ext = {'jbig2': 'jbig2', 'ccitt': 'g4', 'png': 'png'}[em.fmt]
    for sfx, data in (('mask.' + ext, em.data), ('bg.jp2', eb.data),
                      ('fg.jp2', ef.data)):
        with open(os.path.join(img_dir, '%.6d_%s' % (job.page_idx, sfx)),
                  'wb') as fp:
            fp.write(data)
    meta = {'mask': [em.width, em.height, em.fmt],
            'bg': [eb.width, eb.height, eb.fmt],
            'fg': [ef.width, ef.height, ef.fmt],
            'gray': image_mode == 'L',
            'mask_decode': list(em.decode) if em.decode else None}
    with open(os.path.join(img_dir, '%.6d_meta.json' % job.page_idx),
              'w') as fp:
        json.dump(meta, fp)


def insert_images_mrc(builder, hocr_file, in_pdf=None, image_files=None,
                      dpi=None, dpi_pages=None, bg_compression_flags=None,
                      fg_compression_flags=None, skip_pages=None,
                      img_dir=None, jbig2=True, downsample=None,
                      bg_downsample=None, fg_downsample=None,
                      denoise_mask=DENOISE_FAST, reporter=None, hq_pages=None,
                      hq_bg_compression_flags=None,
                      hq_fg_compression_flags=None, verbose=False,
                      debug=False, tmp_dir=None, report_every=None,
                      stop_after=None,
                      jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
                      mrc_image_format=COMPRESSOR_JPEG2000,
                      mask_compression=COMPRESSOR_JBIG2, threads=None,
                      batch_pages=DEFAULT_BATCH_PAGES, exact_denoise=True,
                      resume=False, errors=None, grayscale_pdf=False,
                      force_1bit_output=False, jbig2_symbol_mode=False,
                      jbig2_bands=1, device=None):
    """Pass 2 (``recode.py:266-529``), batched on ``device``."""
    timing_data = _TimingSink()
    if img_dir is not None:
        os.makedirs(img_dir, exist_ok=True)
    jobs = []
    skipped_pages = 0
    for idx, hocr_page in enumerate(hocr_page_iterator(hocr_file)):
        if skip_pages and idx in skip_pages:
            skipped_pages += 1
            continue
        out_idx = idx - skipped_pages
        if stop_after is not None and out_idx >= stop_after:
            break
        picked_dpi = None
        hocr_dpi = hocr_page_get_scan_res(hocr_page)
        if dpi_pages is not None:
            try:
                picked_dpi = dpi_pages[out_idx]
            except IndexError:
                picked_dpi = None
            if picked_dpi is None:
                picked_dpi = hocr_dpi[1]
        if picked_dpi is None:
            picked_dpi = dpi
        if picked_dpi is not None:
            picked_dpi = int(picked_dpi)
        hq = bool(hq_pages[out_idx]) if hq_pages else False
        word_data = hocr_page_to_word_data(hocr_page)
        jobs.append(PageJob(out_idx, idx, word_data, picked_dpi, hq))

    mask_fmt = COMPRESSOR_JBIG2 if jbig2 else 'png'
    if mask_compression == COMPRESSOR_CCITT:
        mask_fmt = COMPRESSOR_CCITT

    if resume and img_dir is not None:
        jobs = _resume_jobs(builder, jobs, img_dir, mask_fmt, verbose)

    reporting_page_count = 0
    last_time = time()
    # encode-pool width: an explicit threads= (down to 1), else 2 on a
    # 1-core host and up to 4 otherwise
    if threads:
        n_workers = max(1, threads)
    else:
        n_workers = min(4, max(2, os.cpu_count() or 4))
    pool = ThreadPoolExecutor(max_workers=n_workers)
    pending = []   # encode futures; drained IN PAGE ORDER (main thread)
    max_pending = 4 * n_workers   # bounds fg/bg buffers held by the queue

    def encode_page(job, mask_np, fg_np, bg_np, image_mode, fg_qbands=None,
                    bg_qbands=None):
        """Encode one page's components on the pool.  The builder
        insertion happens in the page-ordered drain, not here."""
        bgf = hq_bg_compression_flags if job.hq else bg_compression_flags
        fgf = hq_fg_compression_flags if job.hq else fg_compression_flags
        em, eb, ef = encode_mrc_images(
            mask_np, fg_np, bg_np,
            bg_compression_flags=bgf, fg_compression_flags=fgf,
            mask_fmt=mask_fmt, embedded_jbig2=True,
            jpeg2000_implementation=jpeg2000_implementation,
            mrc_image_format=mrc_image_format, tmp_dir=tmp_dir,
            threads=threads, timing_data=timing_data, debug=debug,
            jbig2_symbol_mode=jbig2_symbol_mode, jbig2_bands=jbig2_bands,
            fg_qbands=fg_qbands, bg_qbands=bg_qbands, device=device)
        if img_dir is not None:
            _write_artifacts(img_dir, job, image_mode, em, eb, ef)
        return job, image_mode == 'L', em, eb, ef

    def drain_one(fut):
        """Insert one finished page's streams (main thread, page order)."""
        job, gray, em, eb, ef = fut.result()
        t = time()
        builder.insert_image(job.page_idx, eb, gray=gray)
        builder.insert_image(job.page_idx, ef, gray=gray, mask_enc=em)
        timing_data.append(('page_image_insertion', time() - t))

    def jp2_transforms(plain, fg_dev, bg_dev):
        """-J tpu: the batch transforms of the pages ``plain`` (the
        batch's non-HQ pages) of the device layers, the bg in one call
        and the fg in groups of JP2_FG_GROUP.  Returns, for fg and bg,
        {page: (fetch of its qbands, meta, its index in the transform)}
        (``recode.py:583-651``)."""
        if not plain:
            return {}, {}
        t = time()
        if len(plain) < fg_dev.shape[0]:
            idx = torch.tensor(plain, device=fg_dev.device)
            fg_dev = fg_dev.index_select(0, idx)
            bg_dev = bg_dev.index_select(0, idx)
        fargs = _jp2_transform_args(fg_compression_flags)
        fg_qb = {}
        for a in range(0, len(plain), JP2_FG_GROUP):
            sub = fg_dev[a:a + JP2_FG_GROUP]
            fetch, meta = transform_jp2_batch_async(sub, **fargs)
            for k in range(int(sub.shape[0])):
                fg_qb[plain[a + k]] = ((lambda k=k, f=fetch: f(k)), meta, k)
        fetch, meta = transform_jp2_batch_async(
            bg_dev, **_jp2_transform_args(bg_compression_flags))
        bg_qb = {i: ((lambda k=k, f=fetch: f(k)), meta, k)
                 for k, i in enumerate(plain)}
        timing_data.append(('jp2_batch_transform', time() - t))
        return fg_qb, bg_qb

    def process_batch(batch_jobs, batch_images):
        mode = batch_images[0].mode
        arrs = [np.asarray(im) for im in batch_images]

        if mode == '1':
            # bitonal source: mask-only page (``recode.py:376-396``)
            for job, arr in zip(batch_jobs, arrs):
                em = encode_mrc_mask(arr.astype(bool), fmt=mask_fmt,
                                     embedded=True, timing_data=timing_data,
                                     debug=debug)
                t = time()
                builder.insert_raw_mask_page(job.page_idx, em)
                timing_data.append(('page_image_insertion', time() - t))
            return

        pages = arrs
        if grayscale_pdf and mode == 'RGB':
            # the conversion stays on the device and feeds the MRC
            t = time()
            pages = special_gray_convert(
                torch.from_numpy(np.stack(arrs)).to(device))
            mode = 'L'
            synchronize(device)
            timing_data.append(('special_gray_convert', time() - t))

        mask_dev, dev_imgs = decompose_masks(
            pages, [j.word_data for j in batch_jobs], dpi=batch_jobs[0].dpi,
            downsample=downsample, denoise_mask=denoise_mask,
            exact_denoise=exact_denoise, timing_data=timing_data,
            device=device)

        if force_1bit_output:
            # the inverted mask alone, as a mask-only page
            masks = unpack_mask_bits(pack_mask_bits(mask_dev),
                                     int(mask_dev.shape[-1]))
            for job, mask in zip(batch_jobs, masks):
                em = encode_mrc_mask(~mask, fmt=mask_fmt, embedded=True,
                                     timing_data=timing_data, debug=debug)
                t = time()
                builder.insert_raw_mask_page(job.page_idx, em)
                timing_data.append(('page_image_insertion', time() - t))
            return
        # HQ pages keep full-resolution layers
        any_hq = any(j.hq for j in batch_jobs)
        all_hq = all(j.hq for j in batch_jobs)
        # -J tpu transforms the layers on the device: their pixels never
        # come back to the host
        dev_layers = (jpeg2000_implementation == JPEG2000_IMPL_TPU
                      and mrc_image_format == COMPRESSOR_JPEG2000
                      and not all_hq)
        fg_layers, bg_layers = decompose_layers(
            mask_dev, dev_imgs,
            bg_downsample=None if all_hq else bg_downsample,
            fg_downsample=None if all_hq else fg_downsample,
            timing_data=timing_data, errors=errors, device=dev_layers)
        t = time()
        packed_np = pack_mask_bits(mask_dev).cpu().numpy()
        h_m, w_m = int(mask_dev.shape[1]), int(mask_dev.shape[2])
        if (mask_fmt == COMPRESSOR_JBIG2 and not jbig2_symbol_mode
                and jbig2_bands <= 1):
            # generic JBIG2 in one region consumes the packed rows
            masks = [PackedMask(packed_np[i], w_m, h_m)
                     for i in range(packed_np.shape[0])]
        else:
            masks = unpack_mask_bits(packed_np, w_m)
        timing_data.append(('mask_fetch', time() - t))

        hq_layers = {}
        if any_hq and not all_hq and (bg_downsample or fg_downsample):
            # one call for every HQ page of a mixed batch
            hq_idx = [i for i, job in enumerate(batch_jobs) if job.hq]
            sel = torch.tensor(hq_idx, device=mask_dev.device)
            f, b = decompose_layers(mask_dev.index_select(0, sel),
                                    dev_imgs.index_select(0, sel),
                                    timing_data=timing_data, errors=errors)
            hq_layers = {i: (f[k], b[k]) for k, i in enumerate(hq_idx)}

        fg_qb, bg_qb = {}, {}
        if dev_layers:
            fg_qb, bg_qb = jp2_transforms(
                [i for i, job in enumerate(batch_jobs)
                 if not job.hq and i not in hq_layers], fg_layers, bg_layers)

        for i, job in enumerate(batch_jobs):
            if i in fg_qb:
                # the qbands carry all the encoder needs
                fg = bg = None
            else:
                # numpy, or with dev_layers an HQ page's device tensor
                fg, bg = hq_layers.get(i, (fg_layers[i], bg_layers[i]))
            pending.append(pool.submit(encode_page, job, masks[i], fg, bg,
                                       mode, fg_qb.get(i), bg_qb.get(i)))
        while len(pending) > max_pending:
            drain_one(pending.pop(0))

    # a document of one batch goes in two halves, so the second half's
    # load and device work overlap the first half's host encode
    # (``recode.py:686-688``).  With -J tpu this also decides the bytes:
    # the pack shifts are shared by the pages of one transform.
    if 4 <= len(jobs) <= batch_pages:
        batch_pages = (len(jobs) + 1) // 2

    # a loader thread decodes and batches images (by shape/mode/dpi)
    # while the main thread drives the device; queue depth 2 = double
    # buffering
    batch_queue = queue.Queue(maxsize=2)
    load_error = []
    stop_loading = threading.Event()

    def loader():
        batch_jobs, batch_images, batch_key = [], [], None
        try:
            for job in jobs:
                if stop_loading.is_set():
                    return
                image = _load_page_image(
                    in_pdf, image_files,
                    job.src_idx if image_files else job.page_idx,
                    downsample, jpeg2000_implementation, threads, debug,
                    timing_data)
                key = (image.size,
                       image.mode if image.mode in ('1', 'L', 'RGB')
                       else 'RGB', job.dpi)
                if image.mode not in ('1', 'L', 'RGB'):
                    image = image.convert('RGB')
                if batch_key is not None and (key != batch_key
                                              or len(batch_jobs)
                                              >= batch_pages):
                    batch_queue.put((batch_jobs, batch_images))
                    batch_jobs, batch_images = [], []
                batch_key = key
                batch_jobs.append(job)
                batch_images.append(image)
            if batch_jobs:
                batch_queue.put((batch_jobs, batch_images))
        except BaseException as exc:  # surfaced in the main thread
            load_error.append(exc)
        finally:
            batch_queue.put(None)

    loader_thread = threading.Thread(target=loader, daemon=True)
    loader_thread.start()

    processed = 0
    try:
        while True:
            t = time()
            item = batch_queue.get()
            timing_data.append(('batch_wait', time() - t))
            if item is None:
                break
            batch_jobs, batch_images = item
            process_batch(batch_jobs, batch_images)
            processed += len(batch_jobs)
            reporting_page_count += len(batch_jobs)
            if report_every is not None \
                    and reporting_page_count >= report_every:
                print('Processed %d PDF pages.' % processed)
                sys.stdout.flush()
                if reporter:
                    ms = int(((time() - last_time) / reporting_page_count)
                             * 1000)
                    reporter.send({
                        'compress_pages': {'count': reporting_page_count,
                                           'time-per': ms},
                        'page_time_breakdown': get_timing_summary(
                            timing_data.drain())})
                    last_time = time()
                reporting_page_count = 0
        for fut in pending:
            drain_one(fut)
        pending = []
    finally:
        # on an error, stop the loader and unblock it before leaving
        stop_loading.set()
        while loader_thread.is_alive():
            try:
                batch_queue.get(timeout=0.1)
            except queue.Empty:
                pass
        loader_thread.join()
        pool.shutdown(cancel_futures=True)
    if load_error:
        raise load_error[0]

    if reporter and reporting_page_count:
        ms = int(((time() - last_time) / max(reporting_page_count, 1))
                 * 1000)
        reporter.send({'compress_pages': {'count': reporting_page_count,
                                          'time-per': ms},
                       'page_time_breakdown': get_timing_summary(timing_data)})
    if verbose and timing_data:
        print('MRC time breakdown:', get_timing_summary(timing_data))
    return timing_data


def insert_images_legacy(builder, in_pdf, mode, report_every=None,
                         stop_after=None):
    """Image modes 0/1 (``recode.py:532-558``): a source page's one
    JPEG or JPEG2000 image passed through (0), else the page rendered
    whole and re-encoded as JPEG (1, and any page mode 0 cannot pass)."""
    for idx in range(min(in_pdf.page_count(), len(builder.pages))):
        if stop_after is not None and idx >= stop_after:
            break
        imgs = in_pdf.page_images(idx)
        if not imgs:
            continue
        _, _, stream = imgs[0]
        raw, filt, w, h, cs = in_pdf.extract_image(stream)
        gray = cs in ('DeviceGray', None)
        if mode == IMAGE_MODE_PASSTHROUGH and len(imgs) == 1 and \
                filt in ('DCTDecode', 'JPXDecode'):
            fmt = (COMPRESSOR_JPEG if filt == 'DCTDecode'
                   else COMPRESSOR_JPEG2000)
            builder.insert_image(idx, EncodedLayer(raw, fmt, w, h, gray),
                                 gray=gray)
        else:
            img = _render_page_composite(in_pdf, idx)
            buf = io.BytesIO()
            img.save(buf, format='JPEG', quality=90)
            builder.insert_image(
                idx, EncodedLayer(buf.getvalue(), COMPRESSOR_JPEG,
                                  img.size[0], img.size[1],
                                  img.mode == 'L'),
                gray=img.mode == 'L')
        if report_every is not None and idx % report_every == 0:
            print('Processed %d PDF pages.' % (idx + 1))
            sys.stdout.flush()


def _stamp_producer(builder):
    """Name this engine in an XMP carried over from a source PDF that the
    JAX package wrote: there it names the JAX engine (pdf:Producer and a
    default xmp:CreatorTool), which this engine's output swaps for the
    name the builder stamped in Info, so Info and XMP agree, as PDF/A
    asks.  The builder's own XMP already holds that name."""
    if builder.xmp is not None:
        builder.xmp = builder.xmp.replace(
            xmlescape(REFERENCE_PRODUCER),
            xmlescape(builder.info[Name('Producer')]))


def recode(from_pdf=None, from_imagestack=None, dpi=None, hocr_file=None,
           scandata_file=None, out_pdf=None, out_dir=None,
           reporter=None, grayscale_pdf=False, force_1bit_output=False,
           image_mode=IMAGE_MODE_MRC, jbig2=False, verbose=False,
           debug=False, tmp_dir=None, report_every=None, stop_after=None,
           jpeg2000_implementation=JPEG2000_IMPL_PILLOW,
           bg_compression_flags=None, fg_compression_flags=None,
           mrc_image_format=COMPRESSOR_JPEG2000,
           downsample=None, bg_downsample=None, fg_downsample=None,
           denoise_mask=DENOISE_FAST, hq_pages=None,
           hq_bg_compression_flags=None, hq_fg_compression_flags=None,
           threads=None, render_text_lines=False,
           metadata_url=None, metadata_title=None, metadata_author=None,
           metadata_creator=None, metadata_language=None,
           metadata_subject=None, metadata_creatortool=None,
           ignore_invalid_pagenumbers=False,
           mask_compression=COMPRESSOR_JBIG2,
           batch_pages=DEFAULT_BATCH_PAGES, exact_denoise=True,
           resume=False, profile_dir=None, jbig2_symbol_mode=False,
           jbig2_bands=1, skip_pages=None, device=None):
    """Whole-tool pipeline (``recode.py:562-796``); returns
    {'errors': set, 'compression_ratio': float}.  Same arguments as the
    JAX package's ``recode`` plus ``device`` (default the first GPU;
    ``'cpu'`` runs the plain PyTorch versions of the kernels).

    profile_dir: the span the JAX package traces with jax.profiler (the
    source's opening, pass 1 and pass 2) runs under torch.profiler, with
    the card's kernels when ``device`` is a GPU, and is written as one
    Chrome trace, ``profile_dir/trace.json``.  The PDF is the same."""
    if from_pdf is None and from_imagestack is None:
        raise ValueError('recode: from_pdf or from_imagestack is required')
    device = resolve_device(device)
    errors = set()
    start_time = time()

    # plain recode() callers get the CLI's per-codec default flags
    if image_mode == IMAGE_MODE_MRC and (
            bg_compression_flags is None or fg_compression_flags is None
            or hq_bg_compression_flags is None
            or hq_fg_compression_flags is None):
        if mrc_image_format == COMPRESSOR_JPEG2000:
            dflt = DEFAULT_COMPRESSION_FLAGS[jpeg2000_implementation]
        else:
            dflt = DEFAULT_JPEG_FLAGS
        if bg_compression_flags is None:
            bg_compression_flags = dflt[0].split(' ')
        if fg_compression_flags is None:
            fg_compression_flags = dflt[1].split(' ')
        if hq_bg_compression_flags is None:
            hq_bg_compression_flags = dflt[2].split(' ')
        if hq_fg_compression_flags is None:
            hq_fg_compression_flags = dflt[3].split(' ')

    profiler = None
    if profile_dir:
        from torch.profiler import profile, ProfilerActivity
        activities = [ProfilerActivity.CPU]
        if device.type == 'cuda':
            activities.append(ProfilerActivity.CUDA)
        profiler = profile(activities=activities)
        profiler.__enter__()

    in_pdf = PdfReader(from_pdf) if from_pdf else None
    image_files = sorted(glob(from_imagestack)) if from_imagestack else None

    stop = stop_after
    if stop is not None:
        stop -= 1

    reporter = Reporter(reporter)

    skip_pages = list(skip_pages) if skip_pages else []
    dpi_pages = None
    if scandata_file is not None:
        sd = Scandata(scandata_file)
        skip_pages = sorted(set(skip_pages) | set(sd.skip_pages()))
        dpi_pages = sd.dpi_per_page()
        scandata_doc_dpi = sd.document_dpi()
        if scandata_doc_dpi is not None:
            dpi = scandata_doc_dpi

    builder = DocumentBuilder(render_text_lines=render_text_lines)

    if verbose:
        print('Creating text only PDF')
    t_pass1 = time()
    create_text_pages(builder, hocr_file, in_pdf=in_pdf,
                      image_files=image_files, dpi=dpi,
                      skip_pages=skip_pages, dpi_pages=dpi_pages,
                      reporter=reporter, verbose=verbose, stop_after=stop,
                      jpeg2000_implementation=jpeg2000_implementation,
                      errors=errors)

    hq = [False] * len(builder.pages)
    if hq_pages:
        for i in map(int, hq_pages.split(',')):
            if i > 0:
                i -= 1
            if abs(i) >= len(hq):
                continue   # silently ignore out of range (recode.py:666-672)
            hq[i] = True

    t_pass2 = time()
    if verbose:
        print('Converting with image mode: %s (pass 1 took %.2fs)'
              % (image_mode, t_pass2 - t_pass1))
    if image_mode == IMAGE_MODE_MRC:
        insert_images_mrc(
            builder, hocr_file, in_pdf=in_pdf, image_files=image_files,
            dpi=dpi, dpi_pages=dpi_pages,
            bg_compression_flags=bg_compression_flags,
            fg_compression_flags=fg_compression_flags,
            skip_pages=skip_pages, img_dir=out_dir, jbig2=jbig2,
            downsample=downsample, bg_downsample=bg_downsample,
            fg_downsample=fg_downsample,
            denoise_mask=denoise_mask, reporter=reporter, hq_pages=hq,
            hq_bg_compression_flags=hq_bg_compression_flags,
            hq_fg_compression_flags=hq_fg_compression_flags,
            verbose=verbose, debug=debug, tmp_dir=tmp_dir,
            report_every=report_every, stop_after=stop,
            jpeg2000_implementation=jpeg2000_implementation,
            mrc_image_format=mrc_image_format,
            mask_compression=mask_compression, threads=threads,
            batch_pages=batch_pages, exact_denoise=exact_denoise,
            resume=resume, errors=errors, grayscale_pdf=grayscale_pdf,
            force_1bit_output=force_1bit_output,
            jbig2_symbol_mode=jbig2_symbol_mode, jbig2_bands=jbig2_bands,
            device=device)
    elif image_mode in (IMAGE_MODE_PASSTHROUGH, IMAGE_MODE_PIXMAP):
        if in_pdf is None:
            raise ValueError('recode: image modes 0 and 1 need from_pdf')
        insert_images_legacy(builder, in_pdf, image_mode,
                             report_every=report_every, stop_after=stop)

    if profiler is not None:
        profiler.__exit__(None, None, None)
        os.makedirs(profile_dir, exist_ok=True)
        profiler.export_chrome_trace(os.path.join(profile_dir, 'trace.json'))

    builder.write_pdfa()
    if scandata_file is not None:
        builder.write_page_labels(sd.page_numbers(), errors=errors,
                                  ignore_invalid=ignore_invalid_pagenumbers)
        builder.write_toc(sd.toc())

    lang_if_any = metadata_language[0] if metadata_language else None
    builder.write_basic_ua(language=lang_if_any)

    extra_metadata = {}
    for key, val in (('url', metadata_url), ('title', metadata_title),
                     ('creator', metadata_creator),
                     ('author', metadata_author),
                     ('language', metadata_language),
                     ('subject', metadata_subject),
                     ('creatortool', metadata_creatortool)):
        if val:
            extra_metadata[key] = val
    from_docinfo = None
    from_xmp = None
    if in_pdf is not None:
        # the source's CreationDate and XMP carry over (recode.py:982-996)
        from_docinfo = {}
        v = in_pdf.info().get('CreationDate')
        if v is not None:
            from_docinfo['creationDate'] = v.decode('latin-1') \
                if isinstance(v, bytes) else str(v)
        xmp = in_pdf.xmp_metadata()
        if xmp:
            from_xmp = xmp.decode('utf-8', 'replace')
    builder.write_metadata(extra_metadata=extra_metadata,
                           from_docinfo=from_docinfo, from_xmp=from_xmp)
    _stamp_producer(builder)

    if verbose:
        print('Saving PDF now (pass 2 + finalize took %.2fs)'
              % (time() - t_pass2))
    t = time()
    builder.save(out_pdf, deflate=True)
    save_time_ms = int((time() - t) * 1000)
    if verbose:
        print('PDF save took %.2fs' % (save_time_ms / 1000.0))
    reporter.send({'time_to_save': {'time': save_time_ms}})

    end_time = time()
    n_pages = max(len(builder.pages), 1)
    print('Processed %d pages at %.2f seconds/page'
          % (len(builder.pages), (end_time - start_time) / n_pages))

    if from_pdf is not None:
        oldsize = os.path.getsize(from_pdf)
    else:
        oldsize = 0
        skipped = 0
        for idx, fname in enumerate(image_files):
            if skip_pages and idx in skip_pages:
                skipped += 1
                continue
            if stop_after is not None and (idx - skipped) > stop_after:
                break
            oldsize += os.path.getsize(fname)

    newsize = os.path.getsize(out_pdf)
    compression_ratio = oldsize / newsize if newsize else 0.0
    if verbose:
        print('Compression ratio: %f' % compression_ratio)

    return {'errors': errors, 'compression_ratio': compression_ratio}
