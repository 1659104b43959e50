"""Poseidon encryption over the SAFE sponge (coset-poseidon/src/encryption.rs
+ the unvendored dusk-safe 0.3 encryption mode).

Scheme: absorb [shared_secret.x, shared_secret.y, nonce], squeeze a mask of
message length, cipher = message + mask, absorb the cipher, squeeze one tag
element appended to the ciphertext.  Decryption recomputes the mask/tag and
checks the tag.  The same flow runs over witnesses via GadgetPermutation.
"""

from __future__ import annotations

from ..fields import Fr
from .hades import ScalarPermutation
from .poseidon import Domain
from .safe import Call, Sponge


class DecryptionError(ValueError):
    pass


def _encryption_io_pattern(msg_len: int) -> list[Call]:
    return [Call.absorb(2), Call.absorb(1), Call.squeeze(msg_len),
            Call.absorb(msg_len), Call.squeeze(1)]


def _encrypt_core(safe, message, shared_secret_coords, nonce):
    msg_len = len(message)
    sponge = Sponge.start(safe, _encryption_io_pattern(msg_len),
                          Domain.Encryption.value)
    sponge.absorb(2, shared_secret_coords)
    sponge.absorb(1, [nonce])
    mask = sponge.squeeze(msg_len)
    cipher = [safe.add(m, s) for m, s in zip(message, mask)]
    sponge.absorb(msg_len, cipher)
    tag = sponge.squeeze(1)[0]
    return cipher + [tag]


def _decrypt_core(safe, ciphertext, shared_secret_coords, nonce):
    msg_len = len(ciphertext) - 1
    if msg_len < 1:
        raise DecryptionError("ciphertext too short")
    sponge = Sponge.start(safe, _encryption_io_pattern(msg_len),
                          Domain.Encryption.value)
    sponge.absorb(2, shared_secret_coords)
    sponge.absorb(1, [nonce])
    mask = sponge.squeeze(msg_len)
    message = [safe.subtract(c, s) for c, s in zip(ciphertext, mask)]
    sponge.absorb(msg_len, ciphertext[:msg_len])
    tag = sponge.squeeze(1)[0]
    if not safe.is_equal(tag, ciphertext[msg_len]):
        raise DecryptionError("tag mismatch")
    return message


def encrypt(message, shared_secret, nonce: Fr) -> list[Fr]:
    """Encrypt Fr elements under a Jubjub shared secret
    (encryption.rs:17-33)."""
    coords = [shared_secret.u, shared_secret.v]
    return _encrypt_core(ScalarPermutation(), list(message), coords, nonce)


def decrypt(ciphertext, shared_secret, nonce: Fr) -> list[Fr]:
    """Decrypt + authenticate (encryption.rs:34-50); raises DecryptionError
    on tag mismatch."""
    coords = [shared_secret.u, shared_secret.v]
    return _decrypt_core(ScalarPermutation(), list(ciphertext), coords, nonce)


def encrypt_gadget(composer, message_witnesses, shared_secret_point,
                   nonce_witness) -> list:
    """In-circuit encryption (encryption/gadget.rs:11-27)."""
    from .gadget import GadgetPermutation

    coords = [shared_secret_point.x, shared_secret_point.y]
    return _encrypt_core(GadgetPermutation(composer),
                         list(message_witnesses), coords, nonce_witness)


def decrypt_gadget(composer, ciphertext_witnesses, shared_secret_point,
                   nonce_witness) -> list:
    """In-circuit decryption; the tag check becomes an assert_equal gate
    (encryption/gadget.rs:28-44)."""
    from .gadget import GadgetPermutation

    coords = [shared_secret_point.x, shared_secret_point.y]
    return _decrypt_core(GadgetPermutation(composer),
                         list(ciphertext_witnesses), coords, nonce_witness)
