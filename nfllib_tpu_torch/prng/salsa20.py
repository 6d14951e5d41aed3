"""Salsa20/20 stream cipher — the port's cryptographic PRNG.

Port of nfllib_tpu/prng/salsa20.py, the replacement for the reference's
qhasm x86-64 stream (lib/prng/fastrandombytes.cpp:21-34):
crypto_stream_salsa20 with a 32-byte key, an 8-byte nonce and a 64-bit
little-endian block counter from 0; keystream = serialized final state
words, little-endian.

Three tiers give the same bytes:
  * native (host): csrc/nfl_native.cpp through nfllib_tpu_torch.native,
    behind `Salsa20Stream` when it is available;
  * numpy (host): `salsa20_block_words`, `crypto_stream`, behind
    `Salsa20Stream` otherwise;
  * device: `device_stream_words` / `keystream`, the whole keystream of a
    sampler call in one launch of csrc/salsa20.cu (S1) on a CUDA device,
    or its plain torch twin `salsa20_block_words_torch` on the CPU.

`Salsa20Stream` reproduces fastrandombytes' statefulness: every call
generates from block counter 0 under the current nonce, then increments the
64-bit little-endian nonce by one (reference fastrandombytes.cpp:28-33).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import native
from ..ring import DEFAULT_DEVICE

SIGMA = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)  # "expand 32-byte k"
KEY_BYTES = 32
NONCE_BYTES = 8
BLOCK_BYTES = 64


def _rotl(x, c):
    return (x << np.uint32(c)) | (x >> np.uint32(32 - c))


def salsa20_block_words(key_words, nonce_words, counters):
    """Salsa20/20 keystream blocks.

    key_words: [8] uint32, nonce_words: [2] uint32, counters: [b] uint64
    (block indices).  Returns [b, 16] uint32 final-state words.
    """
    u32 = np.uint32
    b = counters.shape[0]
    ctr_lo = (counters & 0xFFFFFFFF).astype(u32)
    ctr_hi = (counters >> np.uint64(32)).astype(u32)

    def bc(v):  # broadcast a scalar word across blocks
        return np.full((b,), v, dtype=u32)

    x = [
        bc(SIGMA[0]), bc(key_words[0]), bc(key_words[1]), bc(key_words[2]),
        bc(key_words[3]), bc(SIGMA[1]), bc(nonce_words[0]), bc(nonce_words[1]),
        ctr_lo, ctr_hi, bc(SIGMA[2]), bc(key_words[4]),
        bc(key_words[5]), bc(key_words[6]), bc(key_words[7]), bc(SIGMA[3]),
    ]
    j = list(x)  # qr() rebinds list slots (no in-place array mutation below)

    def qr(a, bb, c, d):
        x[bb] = x[bb] ^ _rotl(x[a] + x[d], 7)
        x[c] = x[c] ^ _rotl(x[bb] + x[a], 9)
        x[d] = x[d] ^ _rotl(x[c] + x[bb], 13)
        x[a] = x[a] ^ _rotl(x[d] + x[c], 18)

    for _ in range(10):  # 20 rounds = 10 double rounds
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)

    out = [x[i] + j[i] for i in range(16)]
    return np.stack(out, axis=-1)


def crypto_stream(nbytes: int, nonce: bytes, key: bytes,
                  offset: int = 0) -> bytes:
    """crypto_stream_salsa20(out, nbytes, nonce, key): keystream bytes;
    with `offset`, the bytes offset .. offset + nbytes - 1 of that stream
    (made from the block they start in, not from the stream's start)."""
    if len(key) != KEY_BYTES or len(nonce) != NONCE_BYTES:
        raise ValueError("Salsa20 needs a 32-byte key and an 8-byte nonce")
    if nbytes == 0:
        return b""
    kw = np.frombuffer(key, dtype="<u4").astype(np.uint32)
    nw = np.frombuffer(nonce, dtype="<u4").astype(np.uint32)
    first, skip = divmod(offset, BLOCK_BYTES)
    nblocks = (skip + nbytes + BLOCK_BYTES - 1) // BLOCK_BYTES
    words = salsa20_block_words(kw, nw, np.arange(
        first, first + nblocks, dtype=np.uint64))
    return words.astype("<u4").tobytes()[skip:skip + nbytes]


class Salsa20Stream:
    """fastrandombytes-equivalent stateful stream (nonce bumped per call).

    Uses the native C++ tier (csrc/nfl_native.cpp via
    nfllib_tpu_torch.native) when it is available, the numpy tier
    otherwise: both emit the identical byte stream (golden-anchored in
    tests)."""

    def __init__(self, key: bytes, nonce: int = 0):
        if len(key) != KEY_BYTES:
            raise ValueError("Salsa20 key must be 32 bytes")
        self.key = bytes(key)
        self.nonce = int(nonce)
        self._native = native if native.available() else None

    @classmethod
    def from_system_entropy(cls) -> "Salsa20Stream":
        from .entropy import randombytes
        return cls(randombytes(KEY_BYTES))

    def randombytes(self, nbytes: int, offset: int = 0) -> bytes:
        """`nbytes` of keystream at the current nonce, then the nonce + 1;
        with `offset`, the bytes from there on of the same call's stream
        (a channel block's share of a draw: the nonce moves as for the
        whole draw)."""
        nonce = int(self.nonce).to_bytes(NONCE_BYTES, "little")
        if self._native is not None:
            out = self._native.salsa20_stream(nbytes, nonce, self.key,
                                              offset)
        else:
            out = crypto_stream(nbytes, nonce, self.key, offset)
        self.nonce = (self.nonce + 1) & 0xFFFFFFFFFFFFFFFF
        return out

    def random_words(self, count: int, dtype, offset: int = 0) -> np.ndarray:
        """Keystream reinterpreted as little-endian words of `dtype`, from
        word `offset` of the call's stream on."""
        itemsize = np.dtype(dtype).itemsize
        buf = self.randombytes(count * itemsize, offset * itemsize)
        return np.frombuffer(
            buf, dtype=np.dtype(dtype).newbyteorder("<")).astype(dtype)


# ---------------------------------------------------------------------------
# device tier (S1 and its twin)
# ---------------------------------------------------------------------------

_M32 = 0xFFFFFFFF
_M64 = (1 << 64) - 1


def _rotl_i64(x, c):
    """rotate left of int64 tensors holding uint32 words"""
    return ((x << c) & _M32) | (x >> (32 - c))


def salsa20_block_words_torch(key_words, nonce_words, counters):
    """Plain torch twin of S1 (csrc/salsa20.cu): Salsa20/20 keystream blocks.

    key_words: [8] int64 uint32 words; nonce_words: [..., 2] int64 uint32
    words (lo, hi), one nonce per leading index; counters: [b] int64 block
    indices >= 0.  Returns [..., b, 16] int64 uint32 final-state words.
    Torch has no uint32 add on the CPU, so every add is masked to 32 bits.
    """
    lead = nonce_words.shape[:-1]
    shape = lead + counters.shape
    sigma = torch.tensor(SIGMA, dtype=torch.int64, device=counters.device)

    def bc(v):  # a word, broadcast across nonces and blocks
        return torch.broadcast_to(v, shape)

    n0 = nonce_words[..., 0:1]
    n1 = nonce_words[..., 1:2]
    x = [
        bc(sigma[0]), bc(key_words[0]), bc(key_words[1]), bc(key_words[2]),
        bc(key_words[3]), bc(sigma[1]), bc(n0), bc(n1),
        bc(counters & _M32), bc(counters >> 32), bc(sigma[2]),
        bc(key_words[4]), bc(key_words[5]), bc(key_words[6]),
        bc(key_words[7]), bc(sigma[3]),
    ]
    j = list(x)

    def qr(a, bb, c, d):
        x[bb] = x[bb] ^ _rotl_i64((x[a] + x[d]) & _M32, 7)
        x[c] = x[c] ^ _rotl_i64((x[bb] + x[a]) & _M32, 9)
        x[d] = x[d] ^ _rotl_i64((x[c] + x[bb]) & _M32, 13)
        x[a] = x[a] ^ _rotl_i64((x[d] + x[c]) & _M32, 18)

    for _ in range(10):  # 20 rounds = 10 double rounds
        qr(0, 4, 8, 12)
        qr(5, 9, 13, 1)
        qr(10, 14, 2, 6)
        qr(15, 3, 7, 11)
        qr(0, 1, 2, 3)
        qr(5, 6, 7, 4)
        qr(10, 11, 8, 9)
        qr(15, 12, 13, 14)

    return torch.stack([(x[i] + j[i]) & _M32 for i in range(16)], dim=-1)


def _signed64(v: int) -> int:
    """a 64-bit word (any Python int, taken mod 2^64) as the int64 value of
    its bit pattern"""
    v &= _M64
    return v - (1 << 64) if v >> 63 else v


def nonce_add(nonce, k):
    """nonce + k mod 2^64, each a Python int or a 0-d int64 tensor (the bit
    pattern of a 64-bit word); a tensor stays on its device, unread."""
    if isinstance(nonce, torch.Tensor) or isinstance(k, torch.Tensor):
        if not isinstance(nonce, torch.Tensor):
            nonce, k = k, nonce
        return nonce + (_signed64(k) if isinstance(k, int) else k)
    return (int(nonce) + int(k)) & _M64


def keystream(key: bytes, nonce, nblocks: int, fills: int = 1,
              device=DEFAULT_DEVICE) -> torch.Tensor:
    """The first `nblocks` 64-byte blocks of the streams at nonces nonce,
    nonce + 1, ..., nonce + fills - 1 (mod 2^64): int32 [fills, nblocks *
    16] holding the uint32 words, so the tensor's bytes are the keystream
    bytes (little-endian) and `.view(torch.uint8 / int16 / int64)` reads
    them as bytes or 16- / 64-bit stream limbs.

    `nonce` is a Python int or a 0-d int64 tensor on `device` (the bit
    pattern of the 64-bit nonce); a tensor is never read on the host.  On a
    CUDA device this is one launch of S1; on the CPU its twin,
    keystream_plain."""
    if len(key) != KEY_BYTES:
        raise ValueError("Salsa20 key must be 32 bytes")
    device = torch.device(device)
    if device.type == "cuda":
        from .._kernels import SALSA20
        return SALSA20(key, nonce, nblocks, fills, device)
    return keystream_plain(key, nonce, nblocks, fills, device)


def keystream_plain(key: bytes, nonce, nblocks: int, fills: int = 1,
                    device=DEFAULT_DEVICE, start: int = 0) -> torch.Tensor:
    """S1's plain torch twin: keystream's result on any device (the CPU
    path of keystream; on the card only to check the kernel).  `start`:
    the first block's counter, so that a draw that reads the stream from
    there on makes none of the blocks before it."""
    if isinstance(nonce, torch.Tensor):
        base = nonce.to(device=device, dtype=torch.int64).reshape(())
    else:
        base = torch.tensor(_signed64(int(nonce)), dtype=torch.int64,
                            device=device)
    nonces = base + torch.arange(fills, dtype=torch.int64, device=device)
    nw = torch.stack([nonces & _M32, (nonces >> 32) & _M32], dim=-1)
    kw = torch.from_numpy(np.frombuffer(key, dtype="<u4").astype(np.int64))
    words = salsa20_block_words_torch(
        kw.to(device), nw, torch.arange(start, start + nblocks,
                                        dtype=torch.int64, device=device))
    words = words.reshape(fills, nblocks * 16)
    return (words - ((words >> 31) << 32)).to(torch.int32)


def device_stream_words(key: bytes, nonce, nblocks: int,
                        device=DEFAULT_DEVICE) -> torch.Tensor:
    """On-device keystream: [nblocks, 16] int32 holding the uint32 words
    (the port's u32 storage), whose bytes equal Salsa20Stream's for the
    same (key, nonce), as nfllib_tpu/prng/salsa20.py:device_stream_words.
    `nonce` may be a Python int or a 0-d int64 tensor on `device`, so
    nonces can be computed on the device and never read back."""
    return keystream(key, nonce, nblocks, 1, device).reshape(nblocks, 16)
