# Copied from archive_pdf_tools_tpu/pdf/crypt.py by
# archive_pdf_tools_tpu_torch/tools/copy_shared.py; verbatim.
"""PDF standard security handler (reader-side decryption).

The reference reads encrypted PDFs through PyMuPDF (``recode.py:35``);
our from-scratch reader implements the standard handler directly:
RC4 40/128-bit (V1/V2, R2/R3), crypt filters V4 (RC4 / AESV2) and
V5 (AESV3 / AES-256, revisions 5 and 6).  Key derivation per PDF 32000
§7.6.3 (MD5 algorithm 2) and §7.6.4.3.3/4 (SHA-2 algorithm 2.A); bulk
ciphers live in native/crypto.cpp.

Only empty-user-password documents decrypt automatically (the common
"owner-locked" case); pass ``password=`` for others.
"""

import ctypes
import hashlib
import struct

import numpy as np

PAD = bytes([
    0x28, 0xBF, 0x4E, 0x5E, 0x4E, 0x75, 0x8A, 0x41, 0x64, 0x00, 0x4E, 0x56,
    0xFF, 0xFA, 0x01, 0x08, 0x2E, 0x2E, 0x00, 0xB6, 0xD0, 0x68, 0x3E, 0x80,
    0x2F, 0x0C, 0xA9, 0xFE, 0x64, 0x53, 0x69, 0x7A])


def _lib():
    from ..codecs.jbig2 import _get_lib
    lib = _get_lib()
    if not getattr(lib, '_crypt_proto', False):
        lib.apt_rc4.restype = None
        lib.apt_rc4.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.apt_aes_cbc_decrypt.restype = ctypes.c_long
        lib.apt_aes_cbc_decrypt.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_long,
            ctypes.POINTER(ctypes.c_uint8)]
        lib.apt_aes_cbc_nopad.restype = ctypes.c_long
        lib.apt_aes_cbc_nopad.argtypes = [
            ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_long, ctypes.c_int, ctypes.POINTER(ctypes.c_uint8)]
        lib._crypt_proto = True
    return lib


def rc4(key, data):
    out = np.empty(len(data), np.uint8)
    _lib().apt_rc4(bytes(key), len(key), bytes(data), len(data),
                   out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return out.tobytes()


def aes_cbc_decrypt(key, data):
    """data = IV || ciphertext; strips PKCS#7 padding."""
    if len(data) < 32 or len(data) % 16:
        return b''
    out = np.empty(len(data), np.uint8)
    n = _lib().apt_aes_cbc_decrypt(
        bytes(key), len(key) * 8, bytes(data), len(data),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        return b''
    return out[:n].tobytes()


def aes_cbc_nopad(key, iv, data, decrypt):
    out = np.empty(len(data), np.uint8)
    n = _lib().apt_aes_cbc_nopad(
        bytes(key), len(key) * 8, bytes(iv), bytes(data), len(data),
        1 if decrypt else 0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    if n < 0:
        raise ValueError('aes length not block-aligned')
    return out.tobytes()


def _hash_2a(password, salt, udata=b''):
    """ISO 32000-2 algorithm 2.A (revision 6 hardened hash; revision 5
    is the plain SHA-256 prefix)."""
    k = hashlib.sha256(password + salt + udata).digest()
    i = 0
    while True:
        k1 = (password + k + udata) * 64
        e = aes_cbc_nopad(k[:16], k[16:32], k1, decrypt=False)
        mod = sum(e[:16]) % 3
        k = (hashlib.sha256, hashlib.sha384, hashlib.sha512)[mod](e).digest()
        i += 1
        if i >= 64 and e[-1] <= i - 32:
            return k[:32]


class StandardDecryptor:
    """Built from the /Encrypt dictionary + first document ID string."""

    def __init__(self, enc, id0, password=b'', resolve=lambda x: x):
        g = lambda k, d=None: resolve(enc.get(k, d))
        if str(g('Filter', 'Standard')) != 'Standard':
            raise ValueError('unsupported security handler %r'
                             % (g('Filter'),))
        self.v = int(g('V', 0))
        self.r = int(g('R', 2))
        self.length = int(g('Length', 40))
        o = _strbytes(g('O', b''))
        u = _strbytes(g('U', b''))
        p = int(g('P', -1)) & 0xFFFFFFFF
        self.stm_cfm = self.str_cfm = 'V2' if self.v <= 2 else None
        if self.v in (4, 5):
            cf = g('CF', {}) or {}
            stmf = str(g('StmF', 'Identity'))
            strf = str(g('StrF', 'Identity'))

            def cfm(name):
                if name == 'Identity':
                    return 'Identity'
                d = resolve(cf.get(name, {})) or {}
                return str(resolve(d.get('CFM', 'None')))

            self.stm_cfm = cfm(stmf)
            self.str_cfm = cfm(strf)

        if self.r <= 4:
            em = g('EncryptMetadata', True)
            pw = (password + PAD)[:32]
            h = hashlib.md5(pw + o[:32] + struct.pack('<I', p) + id0)
            if self.r >= 4 and em is False:
                h.update(b'\xff\xff\xff\xff')
            key = h.digest()
            n = 5 if self.r == 2 else max(5, self.length // 8)
            if self.r >= 3:
                for _ in range(50):
                    key = hashlib.md5(key[:n]).digest()
            self.key = key[:n]
        elif self.r in (5, 6):
            ue = _strbytes(g('UE', b''))
            oe = _strbytes(g('OE', b''))
            uh, uvs, uks = u[:32], u[32:40], u[40:48]
            oh, ovs, oks = o[:32], o[32:40], o[40:48]
            pw = password[:127]
            if self.r == 5:
                hu = hashlib.sha256(pw + uvs).digest()
                ho = hashlib.sha256(pw + ovs + u[:48]).digest()
            else:
                hu = _hash_2a(pw, uvs)
                ho = _hash_2a(pw, ovs, u[:48])
            if hu == uh:
                ik = (hashlib.sha256(pw + uks).digest() if self.r == 5
                      else _hash_2a(pw, uks))
                self.key = aes_cbc_nopad(ik, b'\0' * 16, ue, decrypt=True)
            elif ho == oh:
                ik = (hashlib.sha256(pw + oks + u[:48]).digest()
                      if self.r == 5 else _hash_2a(pw, oks, u[:48]))
                self.key = aes_cbc_nopad(ik, b'\0' * 16, oe, decrypt=True)
            else:
                raise ValueError('password required')
        else:
            raise ValueError('unsupported /Encrypt revision %d' % self.r)

    def _object_key(self, num, gen, aes):
        if self.r >= 5:
            return self.key
        h = hashlib.md5(self.key + struct.pack('<I', num)[:3]
                        + struct.pack('<I', gen)[:2])
        if aes:
            h.update(b'sAlT')
        return h.digest()[:min(len(self.key) + 5, 16)]

    def _apply(self, cfm, data, num, gen):
        if cfm in ('Identity', 'None') or not data:
            return data
        if cfm in ('V2', None) or cfm == 'V1':
            return rc4(self._object_key(num, gen, aes=False), data)
        if cfm == 'AESV2':
            return aes_cbc_decrypt(self._object_key(num, gen, aes=True),
                                   data)
        if cfm == 'AESV3':
            return aes_cbc_decrypt(self.key, data)
        raise ValueError('unknown crypt filter method %r' % (cfm,))

    def decrypt_stream(self, data, num, gen=0):
        return self._apply(self.stm_cfm, data, num, gen)

    def decrypt_string(self, data, num, gen=0):
        return self._apply(self.str_cfm, data, num, gen)


def _strbytes(v):
    if isinstance(v, bytes):
        return v
    if isinstance(v, str):
        return v.encode('latin-1')
    return bytes(v or b'')
