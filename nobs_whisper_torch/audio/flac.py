"""Native FLAC codec (pure stdlib + NumPy): decoder + encoder.

Part of the audio ingestion layer that replaces the reference's
cpal/CoreAudio capture (SURVEY.md §2.2 names the TPU-side analog as a
"WAV/FLAC file reader, raw PCM stream socket/iterator"). The box has no
soundfile/ffmpeg, and the first real-weight validation target
(LibriSpeech, docs/ROADMAP.md item 1) ships as .flac — so the framework
decodes it natively.

Decoder coverage (the full frame-level format):
  - metadata walk (STREAMINFO parsed, rest skipped)
  - fixed & variable blocking strategies, UTF-8-coded frame/sample numbers
  - all block-size / sample-rate / sample-size header codes
  - subframes: CONSTANT, VERBATIM, FIXED (order 0-4), LPC (order 1-32),
    wasted-bits shift
  - residuals: RICE (4-bit params) and RICE2 (5-bit), any partition
    order, escape partitions (raw n-bit residuals)
  - stereo decorrelation: independent, left/side, right/side, mid/side
  - optional CRC-16 verification per frame (on by default in tests)

Encoder: 16-bit, mono/stereo(independent)/N-channel, per-block fixed
predictor search (order 0-4 by residual magnitude) + rice coding with a
per-block parameter search, verbatim fallback, correct CRC-8/16 and
STREAMINFO MD5 — a valid, genuinely compressing FLAC writer used by the
round-trip tests to exercise every decoder path.

Hot loops (rice stop-bit scan, LPC recurrence) are NumPy-assisted;
fixed-predictor reconstruction is an exact-integer iterated cumsum.

Memory note: the decoder unpacks the whole file to a bit array plus an
int64 index of every 1-bit (~40 bytes of RAM per input byte). That is
fine for utterance-scale inputs (LibriSpeech files are <5 MB) but a
100 MB FLAC needs ~4 GB — decode_max_bytes (default 64 MB) guards
against accidental album-scale inputs; raise it explicitly if needed.
"""

from __future__ import annotations

import hashlib
import struct
from typing import List, Optional, Tuple, Union

import numpy as np

__all__ = ["read_flac", "read_flac_raw", "write_flac", "FlacInfo"]


# --------------------------------------------------------------------------
# CRCs (FLAC frame checksums: CRC-8 poly 0x07, CRC-16 poly 0x8005, init 0)

def _make_crc_table(poly: int, width: int) -> List[int]:
    top = 1 << (width - 1)
    mask = (1 << width) - 1
    table = []
    for byte in range(256):
        r = byte << (width - 8)
        for _ in range(8):
            r = ((r << 1) ^ poly) if (r & top) else (r << 1)
        table.append(r & mask)
    return table


_CRC8_TABLE = _make_crc_table(0x07, 8)
_CRC16_TABLE = _make_crc_table(0x8005, 16)


def _crc8(data: bytes) -> int:
    r = 0
    t = _CRC8_TABLE
    for b in data:
        r = t[r ^ b]
    return r


def _crc16(data: bytes) -> int:
    r = 0
    t = _CRC16_TABLE
    for b in data:
        r = ((r << 8) & 0xFF00) ^ t[(r >> 8) ^ b]
    return r


# --------------------------------------------------------------------------
# Bit reader over a NumPy bit array (MSB-first, as FLAC is specified)

_POW2 = [np.int64(1) << np.arange(n - 1, -1, -1, dtype=np.int64)
         for n in range(0, 65)]


class _BitReader:
    """MSB-first reader over the whole file, backed by ``np.unpackbits``
    plus a precomputed sorted index of 1-bit positions (``ones``) that
    makes unary scans O(1) lookups instead of bit-by-bit walks."""

    def __init__(self, buf: bytes):
        self.buf = buf
        self.bits = np.unpackbits(np.frombuffer(buf, np.uint8))
        self.ones = np.flatnonzero(self.bits).astype(np.int64)
        self.p = 0                      # bit cursor

    # -- scalar reads ------------------------------------------------------
    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.p
        if p + n > len(self.bits):
            raise ValueError("FLAC bitstream truncated")
        v = int(self.bits[p:p + n].astype(np.int64) @ _POW2[n])
        self.p = p + n
        return v

    def read_signed(self, n: int) -> int:
        v = self.read(n)
        return v - (1 << n) if v >= (1 << (n - 1)) else v

    def read_unary(self) -> int:
        """Count 0-bits until the terminating 1-bit (FLAC unary)."""
        i = int(np.searchsorted(self.ones, self.p))
        if i >= len(self.ones):
            raise ValueError("FLAC bitstream: unary ran off the end")
        stop = int(self.ones[i])
        q = stop - self.p
        self.p = stop + 1
        return q

    def align(self) -> None:
        self.p = (self.p + 7) & ~7

    def byte_pos(self) -> int:
        return self.p >> 3

    # -- vectorized rice partition ------------------------------------------
    def read_rice_block(self, m: int, k: int) -> np.ndarray:
        """Decode ``m`` rice(k) codes -> zigzag-decoded signed residuals."""
        if m == 0:
            return np.zeros(0, np.int64)
        ones = self.ones
        i0 = int(np.searchsorted(ones, self.p))
        if k == 0:
            stops = ones[i0:i0 + m]
            if len(stops) < m:
                raise ValueError("FLAC bitstream: rice partition truncated")
            starts = np.concatenate(([self.p], stops[:-1] + 1))
            u = (stops - starts).astype(np.int64)
            self.p = int(stops[-1]) + 1
        else:
            # Stop-bit chain: s_{i+1} = first 1-bit >= s_i + k + 1 (the k
            # bits after a stop are remainder payload, whatever they hold).
            # Each code consumes one stop and skips <= k payload 1-bits, so
            # the chain touches <= m*(k+1)+1 entries of ``ones`` — window
            # that slice, precompute every entry's successor with one
            # vectorized searchsorted, and enumerate the chain by pointer
            # doubling (all iterates in O(log m) vectorized gathers).
            ones_w = ones[i0:i0 + m * (k + 1) + 1]
            w_len = len(ones_w)
            if w_len == 0:
                raise ValueError("FLAC bitstream: rice partition truncated")
            jumps = np.searchsorted(ones_w, ones_w + k + 1).astype(np.int64)
            jumps = np.append(jumps, w_len)          # self-loop sentinel
            path = np.zeros(1, np.int64)             # first stop: index 0
            while len(path) < m:
                path = np.concatenate([path, jumps[path]])
                jumps = jumps[jumps]
            path = path[:m]
            if int(path[-1]) >= w_len:
                raise ValueError("FLAC bitstream: rice partition truncated")
            stops = ones_w[path]
            starts = np.concatenate(([self.p], stops[:-1] + 1 + k))
            q = stops - starts
            rem_idx = stops[:, None] + 1 + np.arange(k, dtype=np.int64)
            if int(rem_idx[-1, -1]) >= len(self.bits):
                raise ValueError("FLAC bitstream: rice partition truncated")
            rem = self.bits[rem_idx].astype(np.int64) @ _POW2[k]
            u = (q << k) | rem
            self.p = int(stops[-1]) + 1 + k
        # zigzag decode
        return (u >> 1) ^ -(u & 1)

    def read_fixed_block(self, m: int, n: int) -> np.ndarray:
        """``m`` raw n-bit two's-complement values (escape partitions)."""
        if m == 0 or n == 0:
            return np.zeros(m, np.int64)
        idx = self.p + np.arange(m, dtype=np.int64)[:, None] * n \
            + np.arange(n, dtype=np.int64)
        if int(idx[-1, -1]) >= len(self.bits):
            raise ValueError("FLAC bitstream: escape partition truncated")
        v = self.bits[idx].astype(np.int64) @ _POW2[n]
        self.p += m * n
        sign = np.int64(1) << (n - 1)
        return np.where(v >= sign, v - (np.int64(1) << n), v)


# --------------------------------------------------------------------------
# UTF-8-style coded numbers (FLAC extends UTF-8 to 36-bit values)

def _read_coded_number(r: _BitReader) -> int:
    b0 = r.read(8)
    if b0 < 0x80:
        return b0
    n_extra = 0
    mask = 0x40
    while b0 & mask:
        n_extra += 1
        mask >>= 1
    if n_extra == 0 or n_extra > 6:
        raise ValueError("FLAC: invalid coded number lead byte")
    v = b0 & (mask - 1)
    for _ in range(n_extra):
        b = r.read(8)
        if (b & 0xC0) != 0x80:
            raise ValueError("FLAC: invalid coded number continuation")
        v = (v << 6) | (b & 0x3F)
    return v


def _write_coded_number(v: int) -> bytes:
    if v < 0x80:
        return bytes([v])
    out = []
    n_extra = 1
    while v >= (1 << (6 * n_extra + (6 - n_extra))):
        n_extra += 1
    for i in range(n_extra):
        out.append(0x80 | ((v >> (6 * (n_extra - 1 - i))) & 0x3F))
    lead_prefix = (0xFF << (7 - n_extra)) & 0xFF
    lead = lead_prefix | (v >> (6 * n_extra))
    return bytes([lead] + out)


# --------------------------------------------------------------------------
# Predictors

_FIXED_COEF = {0: [], 1: [1], 2: [2, -1], 3: [3, -3, 1], 4: [4, -6, 4, -1]}


def _fixed_restore(order: int, warmup: np.ndarray,
                   res: np.ndarray) -> np.ndarray:
    """Exact-integer reconstruction of a fixed-predictor subframe via
    iterated cumsum (order-th finite difference inversion)."""
    w = np.asarray(warmup, np.int64)
    cur = np.asarray(res, np.int64)
    diffs = [w]
    for _ in range(order):
        diffs.append(np.diff(diffs[-1]))
    for lvl in range(order, 0, -1):
        seed = np.int64(diffs[lvl - 1][-1]) if len(diffs[lvl - 1]) else \
            np.int64(0)
        cur = seed + np.cumsum(cur)
    return np.concatenate([w, cur])


def _lpc_restore(coefs: List[int], shift: int, warmup: np.ndarray,
                 res: np.ndarray) -> np.ndarray:
    """x[i] = res[i] + (sum_j c_j * x[i-1-j]) >> shift, exact integers.

    The recurrence is inherently sequential; a plain-int Python loop over
    a preallocated list is the fastest exact form without a C extension.
    """
    order = len(coefs)
    x = [int(v) for v in warmup]
    rl = [int(v) for v in res]
    cs = [int(c) for c in coefs]
    append = x.append
    for r_i in rl:
        acc = 0
        base = len(x) - 1
        for j in range(order):
            acc += cs[j] * x[base - j]
        append(r_i + (acc >> shift))
    return np.asarray(x, np.int64)


# --------------------------------------------------------------------------
# Frame decode

_BLOCKSIZE_CODES = {1: 192, 2: 576, 3: 1152, 4: 2304, 5: 4608,
                    8: 256, 9: 512, 10: 1024, 11: 2048, 12: 4096,
                    13: 8192, 14: 16384, 15: 32768}
_RATE_CODES = {1: 88200, 2: 176400, 3: 192000, 4: 8000, 5: 16000,
               6: 22050, 7: 24000, 8: 32000, 9: 44100, 10: 48000,
               11: 96000}
_SIZE_CODES = {1: 8, 2: 12, 4: 16, 5: 20, 6: 24, 7: 32}


class FlacInfo:
    """Parsed STREAMINFO."""

    def __init__(self, sample_rate: int, channels: int, bits: int,
                 total_samples: int, md5: bytes):
        self.sample_rate = sample_rate
        self.channels = channels
        self.bits = bits
        self.total_samples = total_samples
        self.md5 = md5


def _read_residual(r: _BitReader, block_size: int, order: int) -> np.ndarray:
    method = r.read(2)
    if method > 1:
        raise ValueError(f"FLAC: reserved residual method {method}")
    param_bits = 4 if method == 0 else 5
    escape = (1 << param_bits) - 1
    part_order = r.read(4)
    n_parts = 1 << part_order
    if block_size % n_parts:
        raise ValueError("FLAC: partition order doesn't divide block size")
    if block_size // n_parts < order:
        raise ValueError("FLAC: partition size smaller than predictor order")
    out = []
    for p in range(n_parts):
        m = block_size // n_parts - (order if p == 0 else 0)
        param = r.read(param_bits)
        if param == escape:
            nbits = r.read(5)
            out.append(r.read_fixed_block(m, nbits))
        else:
            out.append(r.read_rice_block(m, param))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _read_subframe(r: _BitReader, block_size: int, bps: int) -> np.ndarray:
    if r.read(1):
        raise ValueError("FLAC: subframe padding bit set")
    stype = r.read(6)
    wasted = 0
    if r.read(1):
        wasted = r.read_unary() + 1
    eff = bps - wasted
    if stype == 0:                                         # CONSTANT
        v = r.read_signed(eff)
        out = np.full(block_size, v, np.int64)
    elif stype == 1:                                       # VERBATIM
        out = r.read_fixed_block(block_size, eff)
    elif 8 <= stype <= 12:                                 # FIXED
        order = stype - 8
        warm = np.asarray([r.read_signed(eff) for _ in range(order)],
                          np.int64)
        res = _read_residual(r, block_size, order)
        out = _fixed_restore(order, warm, res)
    elif stype >= 32:                                      # LPC
        order = (stype & 0x1F) + 1
        warm = np.asarray([r.read_signed(eff) for _ in range(order)],
                          np.int64)
        prec = r.read(4) + 1
        if prec == 16:
            raise ValueError("FLAC: invalid qlp precision")
        shift = r.read_signed(5)
        if shift < 0:
            raise ValueError("FLAC: negative qlp shift")
        coefs = [r.read_signed(prec) for _ in range(order)]
        res = _read_residual(r, block_size, order)
        out = _lpc_restore(coefs, shift, warm, res)
    else:
        raise ValueError(f"FLAC: reserved subframe type {stype}")
    return out << wasted if wasted else out


def _read_frame(r: _BitReader, info: FlacInfo,
                verify: bool) -> Optional[np.ndarray]:
    """One frame -> (block_size, channels) int64, or None at EOF."""
    # resync: frames are byte-aligned; tolerate trailing garbage only at EOF
    r.align()
    start_byte = r.byte_pos()
    if start_byte + 2 > len(r.buf):
        return None
    sync = r.read(14)
    if sync != 0x3FFE:
        raise ValueError(f"FLAC: lost frame sync at byte {start_byte}")
    if r.read(1):
        raise ValueError("FLAC: reserved frame-header bit set")
    variable = r.read(1)
    bs_code = r.read(4)
    rate_code = r.read(4)
    ch_code = r.read(4)
    size_code = r.read(3)
    if r.read(1):
        raise ValueError("FLAC: reserved frame-header bit set")
    _read_coded_number(r)                      # frame/sample number
    if bs_code == 0:
        raise ValueError("FLAC: reserved block size code 0")
    elif bs_code == 6:
        block_size = r.read(8) + 1
    elif bs_code == 7:
        block_size = r.read(16) + 1
    else:
        block_size = _BLOCKSIZE_CODES[bs_code]
    if rate_code == 12:
        r.read(8)
    elif rate_code in (13, 14):
        r.read(16)
    elif rate_code == 15:
        raise ValueError("FLAC: invalid sample rate code")
    bps = info.bits if size_code == 0 else _SIZE_CODES.get(size_code)
    if bps is None:
        raise ValueError(f"FLAC: reserved sample size code {size_code}")
    header_bytes = r.buf[start_byte:r.byte_pos()]
    crc8 = r.read(8)
    if verify and _crc8(header_bytes) != crc8:
        raise ValueError("FLAC: frame header CRC-8 mismatch")

    if ch_code <= 7:
        n_ch = ch_code + 1
        chans = [_read_subframe(r, block_size, bps) for _ in range(n_ch)]
        out = np.stack(chans, axis=1)
    elif ch_code in (8, 9, 10):
        # stereo decorrelation: the side channel carries one extra bit
        if ch_code == 8:                                   # left/side
            left = _read_subframe(r, block_size, bps)
            side = _read_subframe(r, block_size, bps + 1)
            out = np.stack([left, left - side], axis=1)
        elif ch_code == 9:                                 # right/side
            side = _read_subframe(r, block_size, bps + 1)
            right = _read_subframe(r, block_size, bps)
            out = np.stack([right + side, right], axis=1)
        else:                                              # mid/side
            mid = _read_subframe(r, block_size, bps)
            side = _read_subframe(r, block_size, bps + 1)
            m2 = (mid << 1) | (side & 1)
            out = np.stack([(m2 + side) >> 1, (m2 - side) >> 1], axis=1)
    else:
        raise ValueError(f"FLAC: reserved channel assignment {ch_code}")

    r.align()
    body = r.buf[start_byte:r.byte_pos()]
    crc16 = r.read(16)
    if verify and _crc16(body) != crc16:
        raise ValueError("FLAC: frame CRC-16 mismatch")
    return out


def _md5_pcm(pcm: np.ndarray, bits: int) -> Optional[bytes]:
    """MD5 of decoded PCM as libFLAC defines it: interleaved channels,
    little-endian signed, bits//8 bytes per sample. Returns None when
    bits is not byte-aligned (MD5 layout is sub-byte-packed there; rare
    and not worth the complexity — verification is skipped)."""
    if bits % 8:
        return None
    width = bits // 8
    flat = pcm.reshape(-1).astype(np.int64)
    b = np.empty((flat.size, width), np.uint8)
    for i in range(width):
        b[:, i] = (flat >> (8 * i)) & 0xFF
    return hashlib.md5(b.tobytes()).digest()


def read_flac_raw(path_or_bytes: Union[str, bytes], *,
                  verify: bool = False,
                  decode_max_bytes: int = 64 * 1024 * 1024,
                  ) -> Tuple[np.ndarray, FlacInfo]:
    """FLAC -> ((n_samples, n_channels) int64 PCM, FlacInfo).

    ``verify=True`` additionally checks every frame's CRC-8/CRC-16 and,
    when STREAMINFO carries a nonzero MD5, the whole-stream PCM MD5 —
    so the first real libFLAC-encoded file is an end-to-end validation
    of the decoder, not just of this codec against its own encoder.
    """
    blob = (path_or_bytes if isinstance(path_or_bytes, bytes)
            else open(path_or_bytes, "rb").read())
    if len(blob) > decode_max_bytes:
        raise ValueError(
            f"FLAC input is {len(blob)} bytes > decode_max_bytes="
            f"{decode_max_bytes}; the decoder needs ~40x the file size "
            "in RAM — pass a larger decode_max_bytes to proceed")
    if blob[:4] != b"fLaC":
        raise ValueError("not a FLAC file (no fLaC marker)")
    pos = 4
    info = None
    while True:
        if pos + 4 > len(blob):
            raise ValueError("FLAC: truncated metadata")
        hdr = int.from_bytes(blob[pos:pos + 4], "big")
        last, btype, length = hdr >> 31, (hdr >> 24) & 0x7F, hdr & 0xFFFFFF
        body = blob[pos + 4:pos + 4 + length]
        if btype == 0:                                     # STREAMINFO
            if length < 34:
                raise ValueError("FLAC: short STREAMINFO")
            bits_ = int.from_bytes(body[10:18], "big")
            rate = bits_ >> 44
            n_ch = ((bits_ >> 41) & 0x7) + 1
            bps = ((bits_ >> 36) & 0x1F) + 1
            total = bits_ & ((1 << 36) - 1)
            info = FlacInfo(rate, n_ch, bps, total, body[18:34])
        pos += 4 + length
        if last:
            break
    if info is None:
        raise ValueError("FLAC: missing STREAMINFO")

    r = _BitReader(blob)
    r.p = pos * 8
    frames = []
    got = 0
    while True:
        if info.total_samples and got >= info.total_samples:
            break
        f = _read_frame(r, info, verify)
        if f is None:
            break
        frames.append(f)
        got += f.shape[0]
    pcm = (np.concatenate(frames, axis=0) if frames
           else np.zeros((0, info.channels), np.int64))
    if info.total_samples:
        pcm = pcm[:info.total_samples]
    if verify and info.md5 != b"\x00" * 16:
        digest = _md5_pcm(pcm, info.bits)
        if digest is not None and digest != info.md5:
            raise ValueError("FLAC: decoded PCM MD5 mismatch "
                             "(stream corrupt or decoder bug)")
    return pcm, info


def read_flac(path_or_bytes: Union[str, bytes], *,
              verify: bool = False) -> Tuple[np.ndarray, int]:
    """FLAC -> (mono float32 in [-1, 1], sample_rate) — the same contract
    as ``read_wav`` (multi-channel averaged to mono; the reference forces
    mono capture, src-tauri/src/audio.rs:263-296)."""
    pcm, info = read_flac_raw(path_or_bytes, verify=verify)
    x = pcm.astype(np.float32) / float(1 << (info.bits - 1))
    if info.channels > 1:
        x = x.mean(axis=1)
    else:
        x = x[:, 0]
    return x.astype(np.float32), info.sample_rate


# --------------------------------------------------------------------------
# Encoder

class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.acc = 0
        self.nbits = 0

    def write(self, v: int, n: int) -> None:
        if n == 0:
            return
        self.acc = (self.acc << n) | (v & ((1 << n) - 1))
        self.nbits += n
        while self.nbits >= 8:
            self.nbits -= 8
            self.out.append((self.acc >> self.nbits) & 0xFF)
        self.acc &= (1 << self.nbits) - 1

    def write_unary(self, q: int) -> None:
        while q >= 32:
            self.write(0, 32)
            q -= 32
        self.write(1, q + 1)

    def align(self) -> None:
        if self.nbits:
            self.write(0, 8 - self.nbits)

    def bytes(self) -> bytes:
        assert self.nbits == 0
        return bytes(self.out)


def _rice_cost(u: np.ndarray, k: int) -> int:
    return int(np.sum(u >> k)) + len(u) * (k + 1)


def _best_rice_k(u: np.ndarray) -> int:
    best_k, best_c = 0, _rice_cost(u, 0)
    for k in range(1, 15):
        c = _rice_cost(u, k)
        if c < best_c:
            best_k, best_c = k, c
    return best_k


def _encode_residual(w: _BitWriter, res: np.ndarray) -> None:
    """Method 0 (RICE), partition order 0, one searched parameter."""
    u = ((res << 1) ^ (res >> 63)).astype(np.int64)        # zigzag
    k = _best_rice_k(u)
    w.write(0, 2)                                          # method RICE
    w.write(0, 4)                                          # partition order
    w.write(k, 4)
    for v in u.tolist():
        w.write_unary(v >> k)
        w.write(v, k)


def _encode_subframe(w: _BitWriter, x: np.ndarray, bps: int) -> None:
    x = np.asarray(x, np.int64)
    if np.all(x == x[0]):                                  # CONSTANT
        w.write(0, 1 + 6 + 1)
        w.write(int(x[0]), bps)
        return
    # fixed-predictor search: order 0-4 by residual magnitude sum
    best_order, best_res, best_cost = 0, x, int(np.sum(np.abs(x)))
    d = x
    for order in range(1, 5):
        if len(x) <= order:
            break
        d = np.diff(d)
        cost = int(np.sum(np.abs(d)))
        if cost < best_cost:
            best_order, best_res, best_cost = order, d, cost
    if best_order:
        res = best_res
        warm = x[:best_order]
    else:
        res = x
        warm = x[:0]
    u = ((res << 1) ^ (res >> 63)).astype(np.int64)
    rice_bits = _rice_cost(u, _best_rice_k(u)) + best_order * bps + 10
    if rice_bits >= len(x) * bps:                          # VERBATIM wins
        w.write(0, 1)
        w.write(1, 6)
        w.write(0, 1)
        for v in x.tolist():
            w.write(v, bps)
        return
    w.write(0, 1)
    w.write(8 | best_order, 6)                             # FIXED
    w.write(0, 1)                                          # no wasted bits
    for v in warm.tolist():
        w.write(v, bps)
    _encode_residual(w, res)


_RATE_TO_CODE = {v: k for k, v in _RATE_CODES.items()}


def write_flac(path, audio: np.ndarray, sample_rate: int = 16000, *,
               block_size: int = 4096) -> None:
    """Encode float32 [-1, 1] (n,) mono or (n, ch) PCM as 16-bit FLAC.

    ``path``: filename or binary file-like. Valid, compressing output
    (fixed predictors + rice); verified round-trip by tests/test_flac.py.
    """
    x = np.asarray(audio)
    if x.ndim == 1:
        x = x[:, None]
    if x.dtype.kind == "f":
        pcm = np.clip(np.round(np.asarray(x, np.float64) * 32768.0),
                      -32768, 32767).astype(np.int64)
    else:
        pcm = np.asarray(x, np.int64)
    n, n_ch = pcm.shape
    if not 1 <= n_ch <= 8:
        raise ValueError(f"unsupported channel count {n_ch}")
    bps = 16

    md5 = hashlib.md5()
    md5.update(pcm.astype("<i2").tobytes())                # interleaved LE

    frames = bytearray()
    frame_idx = 0
    for start in range(0, max(n, 1), block_size):
        blk = pcm[start:start + block_size]
        bs = blk.shape[0]
        if bs == 0:
            break
        w = _BitWriter()
        w.write(0x3FFE, 14)
        w.write(0, 1)                                      # reserved
        w.write(0, 1)                                      # fixed blocking
        if bs == block_size and block_size in {
                v: k for k, v in _BLOCKSIZE_CODES.items()}:
            bs_code = {v: k for k, v in _BLOCKSIZE_CODES.items()}[block_size]
            bs_tail = None
        else:
            bs_code, bs_tail = 7, bs - 1                   # 16-bit at end
        w.write(bs_code, 4)
        rate_code = _RATE_TO_CODE.get(sample_rate)
        rate_tail = None
        if rate_code is None:
            if sample_rate < 65536:
                rate_code, rate_tail = 13, sample_rate     # 16-bit Hz
            elif sample_rate % 10 == 0 and sample_rate // 10 < 65536:
                rate_code, rate_tail = 14, sample_rate // 10
            else:
                raise ValueError(f"cannot encode sample rate {sample_rate}")
        w.write(rate_code, 4)
        w.write(n_ch - 1, 4)                               # independent
        w.write(4, 3)                                      # 16-bit
        w.write(0, 1)                                      # reserved
        for b in _write_coded_number(frame_idx):
            w.write(b, 8)
        if bs_tail is not None:
            w.write(bs_tail, 16)
        if rate_tail is not None:
            w.write(rate_tail, 16 if rate_code in (13, 14) else 8)
        hdr = bytes(w.out)
        assert w.nbits == 0
        w.write(_crc8(hdr), 8)
        for c in range(n_ch):
            _encode_subframe(w, blk[:, c], bps)
        w.align()
        body = bytes(w.out)
        w.write(_crc16(body), 16)
        frames += w.bytes()
        frame_idx += 1

    # STREAMINFO
    si = bytearray()
    si += struct.pack(">HH", min(block_size, n or block_size), block_size)
    si += b"\x00\x00\x00" * 2                              # frame sizes unk.
    packed = (sample_rate << 44) | ((n_ch - 1) << 41) | ((bps - 1) << 36) | n
    si += packed.to_bytes(8, "big")
    si += md5.digest()
    header = b"fLaC" + bytes([0x80]) + len(si).to_bytes(3, "big") + bytes(si)

    blob = header + bytes(frames)
    if hasattr(path, "write"):
        path.write(blob)
    else:
        with open(path, "wb") as f:
            f.write(blob)
