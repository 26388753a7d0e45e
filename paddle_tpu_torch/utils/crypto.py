"""Encrypted model files.

Counterpart of ``paddle_tpu.utils.crypto``, pure Python and copied as it
is: ``CipherUtils``, ``CipherFactory`` and ``Cipher``. The cipher is
HMAC-SHA256 in counter mode (a PRF-CTR stream) with an encrypt-then-MAC
integrity tag, in the same blob format, so a file either package writes
decrypts in the other.
"""

from __future__ import annotations

import hashlib
import hmac
import os
import struct

__all__ = ["CipherUtils", "CipherFactory", "Cipher"]

_MAGIC = b"PTENC1\x00"
_BLOCK = 32  # sha256 output


def _keystream(key: bytes, nonce: bytes, n: int) -> bytes:
    out = bytearray()
    counter = 0
    while len(out) < n:
        out += hmac.new(key, nonce + struct.pack(">Q", counter),
                        hashlib.sha256).digest()
        counter += 1
    return bytes(out[:n])


def _xor(data: bytes, stream: bytes) -> bytes:
    """Bulk XOR via one big-int op (a per-byte Python loop is ~100x
    slower — model files are hundreds of MB)."""
    return (int.from_bytes(data, "big")
            ^ int.from_bytes(stream, "big")).to_bytes(len(data), "big")


class Cipher:
    """(ref: cipher.h Cipher interface: Encrypt/Decrypt/EncryptToFile/
    DecryptFromFile)."""

    def encrypt(self, plaintext: bytes, key: bytes) -> bytes:
        if len(key) < 16:
            raise ValueError("key must be at least 16 bytes")
        nonce = os.urandom(16)
        enc_key = hashlib.sha256(b"enc" + key).digest()
        mac_key = hashlib.sha256(b"mac" + key).digest()
        stream = _keystream(enc_key, nonce, len(plaintext))
        ct = _xor(plaintext, stream)
        body = _MAGIC + nonce + ct
        tag = hmac.new(mac_key, body, hashlib.sha256).digest()
        return body + tag

    def decrypt(self, ciphertext: bytes, key: bytes) -> bytes:
        if len(ciphertext) < len(_MAGIC) + 16 + _BLOCK:
            raise ValueError("ciphertext too short")
        body, tag = ciphertext[:-_BLOCK], ciphertext[-_BLOCK:]
        if not body.startswith(_MAGIC):
            raise ValueError("not a paddle_tpu encrypted blob")
        mac_key = hashlib.sha256(b"mac" + key).digest()
        want = hmac.new(mac_key, body, hashlib.sha256).digest()
        if not hmac.compare_digest(tag, want):
            raise ValueError("integrity check failed: wrong key or "
                             "corrupted data")
        nonce = body[len(_MAGIC):len(_MAGIC) + 16]
        ct = body[len(_MAGIC) + 16:]
        enc_key = hashlib.sha256(b"enc" + key).digest()
        stream = _keystream(enc_key, nonce, len(ct))
        return _xor(ct, stream)

    def encrypt_to_file(self, plaintext: bytes, key: bytes,
                        path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.encrypt(plaintext, key))

    def decrypt_from_file(self, key: bytes, path: str) -> bytes:
        with open(path, "rb") as f:
            return self.decrypt(f.read(), key)


class CipherFactory:
    """(ref: cipher.cc CipherFactory::CreateCipher)."""

    @staticmethod
    def create_cipher(config_file: str = "") -> Cipher:
        return Cipher()


class CipherUtils:
    """(ref: cipher_utils.cc GenKey/GenKeyToFile/ReadKeyFromFile)."""

    @staticmethod
    def gen_key(length_bits: int = 256) -> bytes:
        if length_bits % 8:
            raise ValueError("key length must be a multiple of 8 bits")
        return os.urandom(length_bits // 8)

    @staticmethod
    def gen_key_to_file(length_bits: int, path: str) -> bytes:
        key = CipherUtils.gen_key(length_bits)
        with open(path, "wb") as f:
            f.write(key)
        return key

    @staticmethod
    def read_key_from_file(path: str) -> bytes:
        with open(path, "rb") as f:
            return f.read()
