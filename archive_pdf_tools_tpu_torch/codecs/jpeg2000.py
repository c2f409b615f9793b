# Copied from archive_pdf_tools_tpu/codecs/jpeg2000.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; edit: 'tpu' names the port's host coder.
"""JPEG2000 encode/decode facade.

Same four-backend surface as the reference (``jpeg2000.py:37-213``):
Kakadu / OpenJPEG / Grok via subprocess + tempfile round trips, Pillow
in-process (the only backend guaranteed present in this image; Pillow
bundles OpenJPEG).  Flag strings keep the reference's conventions,
including Pillow's ``key:literal;...`` mini-language.

Differences from the reference: backends are probed with shutil.which up
front so a missing binary fails with a clear error instead of a raw
FileNotFoundError mid-book, and the in-process Pillow path encodes
from/to memory (no tempfiles).
"""

import sys
from ast import literal_eval
from os import close, remove
from shutil import which
from subprocess import check_call, DEVNULL
from tempfile import mkstemp

from PIL import Image
from PIL import Jpeg2KImagePlugin

from ..const import (JPEG2000_IMPL_KAKADU, JPEG2000_IMPL_OPENJPEG,
                     JPEG2000_IMPL_GROK, JPEG2000_IMPL_PILLOW,
                     JPEG2000_IMPL_TPU, JPEG2000_IMPLS,
                     RECODE_RUNTIME_WARNING_INVALID_JP2_HEADERS)

KDU_COMPRESS = 'kdu_compress'
KDU_EXPAND = 'kdu_expand'
OPJ_COMPRESS = 'opj_compress'
OPJ_DECOMPRESS = 'opj_decompress'
GRK_COMPRESS = 'grk_compress'
GRK_DECOMPRESS = 'grk_decompress'

_BINARIES = {
    JPEG2000_IMPL_KAKADU: (KDU_COMPRESS, KDU_EXPAND),
    JPEG2000_IMPL_OPENJPEG: (OPJ_COMPRESS, OPJ_DECOMPRESS),
    JPEG2000_IMPL_GROK: (GRK_COMPRESS, GRK_DECOMPRESS),
}

# per-codec default compression flag strings (bg, fg, hq_bg, hq_fg) —
# the bin/recode_pdf defaults table (reference bin/recode_pdf:204-290).
# Shared by the CLI's flag resolution AND recode()'s API defaulting
# (the reference's recode() crashes on flags=None — jpeg2000.py:58
# reads flags[0] — so its Python API is unusable without replicating
# the CLI's table; ours fills these in).
DEFAULT_COMPRESSION_FLAGS = {
    JPEG2000_IMPL_KAKADU: ('-slope 44250', '-slope 44500',
                           '-slope 43500', '-slope 44500'),
    JPEG2000_IMPL_OPENJPEG: ('-r 500', '-r 750', '-r 100', '-r 300'),
    JPEG2000_IMPL_GROK: ('-r 500', '-r 750', '-r 100', '-r 300'),
    JPEG2000_IMPL_PILLOW: (
        'quality_mode:"rates";quality_layers:[500]',
        'quality_mode:"rates";quality_layers:[750]',
        'quality_mode:"rates";quality_layers:[100]',
        'quality_mode:"rates";quality_layers:[300]'),
    JPEG2000_IMPL_TPU: ('ratio:500', 'ratio:750',
                        'ratio:100', 'ratio:300'),
}
DEFAULT_JPEG_FLAGS = ('-S30', '-S20', '-S40', '-S30')


def impl_available(impl):
    if impl == JPEG2000_IMPL_PILLOW:
        return True
    if impl == JPEG2000_IMPL_TPU:
        # in-tree encoder; the native T1 coder builds on demand with g++
        import os
        from . import jp2host as jp2tpu
        return bool(which('g++')) or os.path.exists(jp2tpu._SO_PATH)
    enc, dec = _BINARIES.get(impl, (None, None))
    return bool(enc and which(enc) and which(dec))


def _check_impl(impl):
    if impl not in JPEG2000_IMPLS:
        raise ValueError('invalid jpeg2000 implementation: %r' % (impl,))
    if not impl_available(impl):
        raise RuntimeError(
            'jpeg2000 implementation %r requires binaries %s in $PATH'
            % (impl, _BINARIES[impl]))


def _pillow_kwargs(flag_str):
    """Parse the ``key:literal;...`` flag string (``jpeg2000.py:207-213``)."""
    kwargs = {}
    for entry in flag_str.split(';'):
        key, val = entry.split(':', maxsplit=1)
        kwargs[key] = literal_eval(val)
    return kwargs


def add_impl_args(args, impl, encode=False, threads=None):
    """Thread flags + binary name per backend (``jpeg2000.py:176-205``)."""
    threads = str(threads) if threads else '1'
    if impl == JPEG2000_IMPL_KAKADU:
        if threads == '1':
            threads = '0'   # kakadu: 0 = no threading machinery
        args += ['-num_threads', threads]
        return [KDU_COMPRESS if encode else KDU_EXPAND] + args
    if impl == JPEG2000_IMPL_OPENJPEG:
        args += ['-threads', threads]
        return [OPJ_COMPRESS if encode else OPJ_DECOMPRESS] + args
    if impl == JPEG2000_IMPL_GROK:
        args += ['-H', threads]
        return [GRK_COMPRESS if encode else GRK_DECOMPRESS] + args
    return args


def encode_jpeg2000(image, outpath, impl, flags, tmp_dir=None, imgtype=None,
                    threads=None, debug=False):
    """Encode a PIL image to a JPEG2000 file (``jpeg2000.py:44-84``)."""
    _check_impl(impl)
    if impl == JPEG2000_IMPL_TPU:
        # in-tree encoder: device DWT + native T1 (codecs/jp2tpu.py).
        # Flag mini-language like Pillow's: 'ratio:500;levels:5;delta:0.5'
        from .jp2tpu import encode_jp2_tpu
        import numpy as np
        kwargs = _pillow_kwargs(flags[0]) if flags and flags[0] else {}
        data = encode_jp2_tpu(np.asarray(image),
                              ratio=kwargs.get('ratio'),
                              base_delta=kwargs.get('delta', 1.0 / 64),
                              levels=int(kwargs.get('levels', 5)),
                              workers=threads)
        with open(outpath, 'wb') as fd:
            fd.write(data)
        return
    if impl == JPEG2000_IMPL_PILLOW:
        kwargs = _pillow_kwargs(flags[0])
        image.save(outpath, format='JPEG2000', **kwargs)
        return

    suffix = '.pnm' if impl == JPEG2000_IMPL_OPENJPEG else '.tif'
    fd, tmp_img = mkstemp(prefix=imgtype or 'img', suffix=suffix, dir=tmp_dir)
    close(fd)
    try:
        image.save(tmp_img)
        args = ['-i', tmp_img, '-o', outpath] + list(flags)
        args = add_impl_args(args, impl, encode=True, threads=threads)
        if debug:
            print('check_call: %s' % args, file=sys.stderr)
        check_call(args, stdout=DEVNULL, stderr=DEVNULL)
    finally:
        remove(tmp_img)


def decode_jpeg2000(infile, reduce_=None, impl=JPEG2000_IMPL_PILLOW,
                    tmp_dir=None, threads=None, debug=False):
    """Decode a JPEG2000 file to a PIL image, optionally at a reduced
    resolution level (``jpeg2000.py:87-148``)."""
    _check_impl(impl)
    if reduce_ is not None:
        reduce_ = int(reduce_ - 1)
        if reduce_ == 1:
            reduce_ = None

    if impl in (JPEG2000_IMPL_PILLOW, JPEG2000_IMPL_TPU):
        # tpu-encoded streams are standard Part-1; decode via Pillow
        img = Image.open(infile)
        if reduce_ is not None:
            img = img.reduce(reduce_)
        img.load()
        return img

    fd, tmp_img = mkstemp(suffix='.tif', dir=tmp_dir)
    close(fd)
    try:
        args = ['-i', infile, '-o', tmp_img]
        if reduce_ is not None:
            if impl == JPEG2000_IMPL_KAKADU:
                args += ['-reduce', str(reduce_ - 1)]
            else:
                args += ['-r', str(reduce_ - 1)]
        args = add_impl_args(args, impl, encode=False, threads=threads)
        if debug:
            print('check_call: %s' % args, file=sys.stderr)
        check_call(args, stdout=DEVNULL, stderr=DEVNULL)
        img = Image.open(tmp_img)
        img.load()
        return img
    finally:
        remove(tmp_img)


def get_jpeg2000_info(infile, impl=JPEG2000_IMPL_PILLOW, errors=None):
    """Fast JP2 header probe for (size, mode) without a full decode
    (``jpeg2000.py:151-173``); falls back to decoding on bad headers."""
    with open(infile, 'rb') as fd:
        try:
            header = Jpeg2KImagePlugin._parse_jp2_header(fd)
            size, mode = header[0], header[1]
            return size, mode
        except Exception:
            if errors is not None:
                errors.add(RECODE_RUNTIME_WARNING_INVALID_JP2_HEADERS)
    img = decode_jpeg2000(infile, impl=impl)
    return img.size, img.mode
