"""KZG10 commitment key, commitments and SRS setup on the device.

Counterpart of `zkvm_tpu/plonk/kzg10.py`, with the same byte layouts
(plonk/src/commitment_scheme/kzg10/{srs.rs, key.rs, commitment.rs}).  Every
commitment runs the device MSM (`zkvm_tpu_torch.ops.msm`) on the key's
device, and the SRS setup runs the device fixed-base multiplication
(`g1_ops.batch_scalar_mul_base`) with the reference's RNG draws in the
reference's order, so one seed gives byte-identical keys.  The opening
checks run on the host through the port's own pairing (`curves.pairing`,
`native`).
"""

from __future__ import annotations

import torch

from ..curves.g1 import G1Affine, G1Projective
from ..curves.g2 import G2Affine
from ..curves.pairing import (G2Prepared, Gt, final_exponentiation,
                              multi_miller_loop)
from ..fields import Fr

from ..ops import g1_ops
from ..ops.msm import MSMContext
from .errors import (DegreeIsZero, NotEnoughBytes, PairingCheckFailure,
                     PlonkError, PointMalformed, PolynomialDegreeIsZero,
                     PolynomialDegreeTooLarge, TruncatedDegreeIsZero,
                     TruncatedDegreeTooLarge)
from .polynomial import Polynomial


class KZGError(PlonkError, ValueError):
    """Legacy catch-all; specific sites raise the typed error.rs variants
    (which subclass PlonkError, so `except KZGError` no longer catches them
    -- use PlonkError)."""


def powers_of(x: Fr, degree: int) -> list[Fr]:
    """[1, x, ..., x^degree] (plonk/src/util.rs powers_of)."""
    out, cur = [], Fr.one()
    for _ in range(degree + 1):
        out.append(cur)
        cur = cur * x
    return out


def _degree(coeffs: list[Fr]) -> int:
    """Degree of a coefficient list, trailing zeros ignored (the reference
    Polynomial's truncation)."""
    n = len(coeffs)
    while n and coeffs[n - 1].is_zero():
        n -= 1
    return max(0, n - 1)


def _device_ctx(commit_key: "CommitKey") -> MSMContext:
    """The key's MSM context (its powers resident on the key's device),
    built on first use."""
    if commit_key._ctx is None:
        commit_key._ctx = MSMContext(commit_key.powers_of_g,
                                     commit_key.device)
    return commit_key._ctx


class Commitment:
    """G1Affine newtype (kzg10/commitment.rs:24)."""

    __slots__ = ("point",)

    SIZE = G1Affine.SIZE

    def __init__(self, point):
        self.point = (point.to_affine() if isinstance(point, G1Projective)
                      else point)

    @classmethod
    def identity(cls):
        return cls(G1Affine.identity())

    def to_bytes(self) -> bytes:
        return self.point.to_bytes()

    @classmethod
    def from_bytes(cls, buf: bytes):
        p = G1Affine.from_bytes(buf)
        return None if p is None else cls(p)

    def __eq__(self, other):
        return isinstance(other, Commitment) and self.point == other.point

    def __hash__(self):
        return hash(self.point)

    def __repr__(self):
        return f"Commitment({self.point!r})"


class KZGProof:
    """Single-point opening proof (kzg10/proof.rs Proof)."""

    __slots__ = ("commitment_to_witness", "evaluated_point",
                 "commitment_to_polynomial")

    def __init__(self, commitment_to_witness: Commitment, evaluated_point: Fr,
                 commitment_to_polynomial: Commitment):
        self.commitment_to_witness = commitment_to_witness
        self.evaluated_point = evaluated_point
        self.commitment_to_polynomial = commitment_to_polynomial


class AggregateProof:
    """Aggregated same-point openings (kzg10/proof.rs AggregateProof)."""

    def __init__(self, witness: Commitment):
        self.commitment_to_witness = witness
        self.evaluated_points: list[Fr] = []
        self.commitments_to_polynomials: list[Commitment] = []

    def add_part(self, evaluation: Fr, commitment: Commitment):
        self.evaluated_points.append(evaluation)
        self.commitments_to_polynomials.append(commitment)

    def flatten(self, v_challenge: Fr) -> KZGProof:
        powers = powers_of(v_challenge,
                           len(self.commitments_to_polynomials) - 1)
        acc = G1Projective.identity()
        for comm, p in zip(self.commitments_to_polynomials, powers):
            acc = acc + comm.point * p
        flattened_eval = Fr.zero()
        for ev, p in zip(self.evaluated_points, powers):
            flattened_eval = flattened_eval + ev * p
        return KZGProof(self.commitment_to_witness, flattened_eval,
                        Commitment(acc))


class CommitKey:
    """Powers-of-tau commit key (kzg10/key.rs:32-147) bound to a device."""

    __slots__ = ("powers_of_g", "device", "_ctx")

    def __init__(self, powers_of_g: list[G1Affine], device):
        self.powers_of_g = powers_of_g
        self.device = torch.device(device)
        self._ctx = None

    @classmethod
    def from_reference(cls, ref, device) -> "CommitKey":
        """A key from the JAX package: its CommitKey (anything with
        `to_raw_var_bytes()`) or those bytes.  The two packages have
        separate point classes, so the key crosses over as bytes."""
        if not isinstance(ref, (bytes, bytearray)):
            ref = ref.to_raw_var_bytes()
        return cls.from_slice_unchecked(bytes(ref), device)

    def max_degree(self) -> int:
        return len(self.powers_of_g) - 1

    def truncate(self, truncated_degree: int) -> "CommitKey":
        if truncated_degree == 0:
            raise TruncatedDegreeIsZero()
        if truncated_degree > self.max_degree():
            raise TruncatedDegreeTooLarge()
        if truncated_degree == 1:
            truncated_degree += 1
        return CommitKey(self.powers_of_g[:truncated_degree + 1],
                         self.device)

    def _check_degree(self, coeffs: list[Fr]) -> None:
        # degree-0 (constant or zero) polynomials are rejected, mirroring
        # check_commit_degree_is_within_bounds (key.rs:108-117)
        degree = _degree(coeffs)
        if degree == 0:
            raise PolynomialDegreeIsZero()
        if degree > self.max_degree():
            raise PolynomialDegreeTooLarge()

    def commit(self, coeffs: list[Fr]) -> Commitment:
        """Commit to a polynomial given by its coefficients."""
        return self.commit_many([coeffs])[0]

    def commit_many(self, polynomials: list[list[Fr]]) -> list[Commitment]:
        """Commit several coefficient lists in one device MSM."""
        for coeffs in polynomials:
            self._check_degree(coeffs)
        polys = [coeffs[:_degree(coeffs) + 1] for coeffs in polynomials]
        return [Commitment(r) for r in _device_ctx(self).msm_many(polys)]

    def commit_many_mont(self, tensors, mesh=None,
                         axis: str | None = None) -> list[Commitment]:
        """Commit device-resident [8, len] Montgomery coefficient tensors
        in one MSM (the device-resident prover's commit path).  With
        `mesh`, whose home is the key's device, the MSM shards points and
        scalars across the mesh (the multi-chip prove)."""
        for t in tensors:
            if t.shape[-1] - 1 > self.max_degree():
                raise PolynomialDegreeTooLarge()
        return [Commitment(r)
                for r in _device_ctx(self).msm_many_mont(
                    list(tensors), mesh=mesh, axis=axis)]

    @staticmethod
    def compute_aggregate_witness(polynomials: list[Polynomial], point: Fr,
                                  v_challenge: Fr) -> Polynomial:
        """The host form of the opening witness: sum_i v^i p_i divided by
        (X - point).  The device form is `dpoly.lin_comb` +
        `dpoly.ruffini_device`."""
        powers = powers_of(v_challenge, len(polynomials) - 1)
        numerator = Polynomial.zero()
        for poly, v in zip(polynomials, powers):
            numerator = numerator + poly.scale(v)
        return numerator.ruffini(point)

    # -- serialization (key.rs:38-82) -----------------------------------------
    def to_var_bytes(self) -> bytes:
        return b"".join(g.to_bytes() for g in self.powers_of_g)

    @classmethod
    def from_slice(cls, buf: bytes, device) -> "CommitKey":
        n = G1Affine.SIZE
        if len(buf) % n:
            raise KZGError("bad CommitKey length")
        out = []
        for i in range(0, len(buf), n):
            g = G1Affine.from_bytes(buf[i: i + n])
            if g is None:
                raise PointMalformed()
            out.append(g)
        return cls(out, device)

    def to_raw_var_bytes(self) -> bytes:
        head = len(self.powers_of_g).to_bytes(8, "little")
        return head + b"".join(g.to_raw_bytes() for g in self.powers_of_g)

    @classmethod
    def from_slice_unchecked(cls, buf: bytes, device) -> "CommitKey":
        n = int.from_bytes(buf[:8], "little")
        body = buf[8:]
        size = G1Affine.RAW_SIZE
        out = []
        for i in range(n):
            chunk = body[i * size:(i + 1) * size]
            if len(chunk) < size:
                break
            out.append(G1Affine.from_slice_unchecked(chunk))
        return cls(out, device)

    def __eq__(self, other):
        return (isinstance(other, CommitKey)
                and self.powers_of_g == other.powers_of_g)


class OpeningKey:
    """Verifier key for single openings (kzg10/key.rs:157-255)."""

    SIZE = G1Affine.SIZE + 2 * G2Affine.SIZE  # 48 + 192

    def __init__(self, g: G1Affine, h: G2Affine, x_h: G2Affine):
        self.g = g
        self.h = h
        self.x_h = x_h
        self.prepared_h = G2Prepared(h)
        self.prepared_x_h = G2Prepared(x_h)

    def to_bytes(self) -> bytes:
        return self.g.to_bytes() + self.h.to_bytes() + self.x_h.to_bytes()

    @classmethod
    def from_bytes(cls, buf: bytes):
        if len(buf) != cls.SIZE:
            return None
        g = G1Affine.from_bytes(buf[:48])
        h = G2Affine.from_bytes(buf[48:144])
        x_h = G2Affine.from_bytes(buf[144:240])
        if g is None or h is None or x_h is None:
            return None
        return cls(g, h, x_h)

    def check(self, point: Fr, proof: KZGProof) -> bool:
        """Single-opening pairing check (key.rs test helper `check`, also the
        shape used by Proof::verify's final equation)."""
        inner_a = (proof.commitment_to_polynomial.point.to_projective()
                   - self.g * proof.evaluated_point).to_affine()
        inner_b = (self.x_h.to_projective() - self.h * point).to_affine()
        prepared_inner_b = G2Prepared(-inner_b)
        result = final_exponentiation(multi_miller_loop([
            (inner_a, self.prepared_h),
            (proof.commitment_to_witness.point, prepared_inner_b),
        ]))
        return result == Gt.identity()

    def batch_check(self, points: list[Fr], proofs: list[KZGProof],
                    transcript) -> bool:
        """Batched pairing check with a transcript-drawn separation challenge
        (key.rs:215-255).  `transcript` is anything with
        `challenge_scalar(label) -> Fr`."""
        total_c = G1Projective.identity()
        total_w = G1Projective.identity()
        u_challenge = transcript.challenge_scalar(b"batch")
        powers = powers_of(u_challenge, len(proofs) - 1)
        g_multiplier = Fr.zero()
        for (proof, u), point in zip(zip(proofs, powers), points):
            c = proof.commitment_to_polynomial.point.to_projective()
            w = proof.commitment_to_witness.point
            c = c + w * point
            g_multiplier = g_multiplier + u * proof.evaluated_point
            total_c = total_c + c * u
            total_w = total_w + w * u
        total_c = total_c - self.g * g_multiplier
        affine_total_w = (-total_w).to_affine()
        affine_total_c = total_c.to_affine()
        from ..native import native_pairing_check

        live = [(p, q) for p, q in ((affine_total_w, self.x_h),
                                    (affine_total_c, self.h))
                if not p.is_identity()]
        ok = native_pairing_check(live) if live else True
        if ok is None:
            ok = final_exponentiation(multi_miller_loop([
                (affine_total_w, self.prepared_x_h),
                (affine_total_c, self.prepared_h),
            ])) == Gt.identity()
        if not ok:
            raise PairingCheckFailure()  # key.rs:252
        return True


class PublicParameters:
    """Universal SRS (kzg10/srs.rs:29-130)."""

    ADDED_BLINDING_DEGREE = 6

    def __init__(self, commit_key: CommitKey, opening_key: OpeningKey):
        self.commit_key = commit_key
        self.opening_key = opening_key

    @classmethod
    def setup(cls, max_degree: int, rng, device) -> "PublicParameters":
        """The reference's setup with the tau powers of g computed on
        `device` (the same draws from `rng`, in the same order)."""
        if max_degree < 1:
            raise DegreeIsZero()
        max_degree += cls.ADDED_BLINDING_DEGREE
        x = Fr.random(rng)
        xs = powers_of(x, max_degree)
        g = G1Affine.generator() * Fr.random(rng)
        normalized = g1_ops.batch_scalar_mul_base(g.to_affine(), xs, device)
        h = (G2Affine.generator() * Fr.random(rng)).to_affine()
        x_2 = (h * x).to_affine()
        return cls(CommitKey(normalized, device),
                   OpeningKey(g.to_affine(), h, x_2))

    def trim(self, truncated_degree: int) -> tuple[CommitKey, OpeningKey]:
        ck = self.commit_key.truncate(
            truncated_degree + self.ADDED_BLINDING_DEGREE)
        return ck, self.opening_key

    def max_degree(self) -> int:
        return self.commit_key.max_degree()

    # -- serialization (srs.rs:73-114) -----------------------------------------
    def to_var_bytes(self) -> bytes:
        return self.opening_key.to_bytes() + self.commit_key.to_var_bytes()

    @classmethod
    def from_slice(cls, buf: bytes, device) -> "PublicParameters":
        if len(buf) <= OpeningKey.SIZE:
            raise NotEnoughBytes()
        ok = OpeningKey.from_bytes(buf[: OpeningKey.SIZE])
        if ok is None:
            raise PointMalformed()
        ck = CommitKey.from_slice(buf[OpeningKey.SIZE:], device)
        return cls(ck, ok)

    def to_raw_var_bytes(self) -> bytes:
        return (self.opening_key.to_bytes()
                + self.commit_key.to_raw_var_bytes())

    @classmethod
    def from_slice_unchecked(cls, buf: bytes, device) -> "PublicParameters":
        ok = OpeningKey.from_bytes(buf[: OpeningKey.SIZE])
        ck = CommitKey.from_slice_unchecked(buf[OpeningKey.SIZE:], device)
        return cls(ck, ok)
