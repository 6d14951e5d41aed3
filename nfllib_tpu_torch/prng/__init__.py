from .entropy import randombytes
from .salsa20 import Salsa20Stream, crypto_stream, device_stream_words

__all__ = [
    "randombytes",
    "Salsa20Stream",
    "crypto_stream",
    "device_stream_words",
]
