"""A circuit's layout and its verifier key, from the circuit's definition
alone: the Merkle-opening circuit, and the gadgets any other circuit is
built from.

The gates follow dusk-plonk's Composer (4 wires a, b, c, d; selectors
q_m q_l q_r q_o q_f q_c q_arith q_range q_logic q_fixed_group_add
q_variable_group_add; a public input is recorded by gate): its arithmetic
gadgets, the range gadget (base-4 accumulator gates), the logic gadget
(AND and XOR), JubJub point addition (the variable-base gate) and
fixed-base multiplication (256 fixed-base gates), the Poseidon gadget of
dusk-poseidon (round constants folded into the MDS gates, the SAFE sponge,
the truncated hash) and the opening gadget of poseidon-merkle (zk.rs).
Only the structure is built: which witness sits on which wire and every
selector value.  No witness value enters the verifier key, so none is
computed.

The verifier key is each selector and sigma column's commitment
[q(tau)] g, q(tau) taken from the column's values on the domain through
the Lagrange basis at tau; a constant column commits to the identity, as
the compiler's `commit(..).unwrap_or_default()` does.
"""

from __future__ import annotations

from . import curve, jubjub
from .field import K1, K2, K3, R, batch_inverse, hash_to_scalar, root_of_unity
from .poseidon import (FULL_ROUNDS, MERKLE4_DOMAIN, PARTIAL_ROUNDS, WIDTH,
                       io_tag_bytes)
from .poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS

SELECTORS = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith",
             "q_range", "q_logic", "q_fixed_group_add",
             "q_variable_group_add")
SIGMAS = ("s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4")
ZERO, ONE = 0, 1  # the composer's first witnesses, the constants 0 and 1
ARITY = 4
# a gate's family selectors (q_arith, q_range, q_logic, q_fixed_group_add,
# q_variable_group_add); a row of the family NONE only carries wires that
# the gate before it reads at the next row (a_w, b_w, d_w)
ARITH = (1, 0, 0, 0, 0)
NONE = (0, 0, 0, 0, 0)
RANGE = (0, 1, 0, 0, 0)
FIXED_BASE = (0, 0, 0, 1, 0)
VARIABLE_BASE = (0, 0, 0, 0, 1)
NO_Q = (0, 0, 0, 0, 0, 0)


class Layout:
    """Gates: (q_m, q_l, q_r, q_o, q_f, q_c), the family selectors
    (`families`, ARITH for an arithmetic gate) and the wires (a, b, c, d)
    as witness indices."""

    def __init__(self):
        self.witnesses = 0
        self.gates: list[tuple] = []
        self.families: list[tuple] = []
        self.wires: list[tuple] = []
        self.public: list[int] = []  # gate indexes that carry a public input
        zero, one = self.witness(), self.witness()
        self.assert_equal_constant(zero, 0)
        self.assert_equal_constant(one, 1)
        six, one_, seven, min_twenty = (self.witness() for _ in range(4))
        # composer.rs:139-151, the two dummy gates
        self.gate((1, 2, 3, 4, 1, 4), (six, seven, min_twenty, one_))
        self.gate((1, 1, 1, 1, 0, 127), (min_twenty, six, seven, ZERO))

    def witness(self) -> int:
        self.witnesses += 1
        return self.witnesses - 1

    def gate(self, q, wires, public: bool = False, family=ARITH) -> None:
        if public:
            self.public.append(len(self.gates))
        self.gates.append(tuple(c % R for c in q))
        self.families.append(tuple(c % R for c in family))
        self.wires.append(tuple(wires))

    def gate_add(self, q, a=ZERO, b=ZERO, d=ZERO) -> int:
        """A gate whose output witness (c, q_o = -1) is allocated first."""
        out = self.witness()
        q_m, q_l, q_r, q_f, q_c = q
        self.gate((q_m, q_l, q_r, -1, q_f, q_c), (a, b, out, d))
        return out

    def assert_equal(self, left: int, right: int) -> None:
        self.gate((0, 1, -1, 0, 0, 0), (left, right, ZERO, ZERO))

    def assert_equal_constant(self, w: int, constant: int) -> None:
        self.gate((0, -1, 0, 0, 0, constant), (w, ZERO, ZERO, ZERO))

    def boolean(self, w: int) -> None:
        self.gate((1, 0, 0, -1, 0, 0), (w, w, w, ZERO))

    def constant(self, value: int) -> int:
        w = self.witness()
        self.assert_equal_constant(w, value)
        return w

    def assert_public(self, w: int) -> None:
        """Composer::assert_equal_constant(w, 0, Some(public)): `w` set
        equal to a public input."""
        self.gate((0, -1, 0, 0, 0, 0), (w, ZERO, ZERO, ZERO), public=True)

    # -- composer.rs: bit decomposition -----------------------------------
    def decomposition(self, scalar: int, n: int) -> list[int]:
        """`n` boolean bits, least significant first, summed back."""
        acc, bits = ZERO, []
        for i in range(n):
            bit = self.witness()
            self.boolean(bit)
            bits.append(bit)
            acc = self.gate_add((0, 1 << i, 1, 0, 0), bit, acc)
        self.assert_equal(acc, scalar)
        return bits

    # -- composer.rs: the range and logic gadgets ---------------------------
    def range(self, w: int, bit_pairs: int) -> None:
        """component_range: base-4 accumulators, four a gate on d, c, b,
        a, the last one alone on d of a closing row, set equal to `w`."""
        num_bits = min(2 * bit_pairs, 256)
        if num_bits == 0:
            self.gate((0, 1, 0, 0, 0, 0), (w, ZERO, ZERO, ZERO))
            return
        num_gates = -(-num_bits // 8)
        num_quads = 4 * num_gates
        pad = 1 + (2 * num_quads - num_bits) // 2
        rows = [[ZERO] * 4 for _ in range(num_gates + 1)]
        acc = ZERO
        for i in range(pad, num_quads + 1):
            acc = self.witness()
            rows[i // 4][(3, 2, 1, 0)[i % 4]] = acc
        rows[-1] = [ZERO, ZERO, ZERO, acc]
        for k, wires in enumerate(rows):
            self.gate(NO_Q, wires, family=RANGE if k < num_gates else NONE)
        self.assert_equal(acc, w)

    def logic(self, a: int, b: int, bit_pairs: int, xor: bool) -> int:
        """append_logic_component: a gate a quad, each reading the last
        quad's accumulators of a, b and the output (a, b, d) and this
        quad's product (c); q_c = q_logic = 1 for AND, -1 for XOR.  The
        output's accumulator is returned."""
        sign = -1 if xor else 1
        acc_a = acc_b = acc_d = ZERO
        for _ in range(min(2 * bit_pairs, 256) // 2):
            next_a, next_b, prod, next_d = (self.witness() for _ in range(4))
            self.gate((0, 0, 0, 0, 0, sign), (acc_a, acc_b, prod, acc_d),
                      family=(0, 0, sign, 0, 0))
            acc_a, acc_b, acc_d = next_a, next_b, next_d
        self.gate(NO_Q, (acc_a, acc_b, ZERO, acc_d), family=NONE)
        return acc_d

    # -- composer.rs: JubJub points -----------------------------------------
    def point(self) -> tuple[int, int]:
        return self.witness(), self.witness()

    def add_point(self, p, q) -> tuple[int, int]:
        """component_add_point: the variable-base gate on (x1, y1, x2, y2)
        and a row of (x3, y3, -, x1 y2)."""
        x1y2, x3, y3 = self.witness(), self.witness(), self.witness()
        self.gate(NO_Q, (p[0], p[1], q[0], q[1]), family=VARIABLE_BASE)
        self.gate(NO_Q, (x3, y3, ZERO, x1y2), family=NONE)
        return x3, y3

    def select_identity(self, bit: int, p) -> tuple[int, int]:
        """component_select_identity: bit ? p : (0, 1), as x = bit x_p
        and y = 1 - bit + bit y_p."""
        x = self.gate_add((1, 0, 0, 0, 0), bit, p[0])
        y = self.witness()
        self.gate((1, -1, 0, -1, 0, 1), (bit, p[1], y, ZERO))
        return x, y

    def mul_point(self, scalar: int, p) -> tuple[int, int]:
        """component_mul_point: 252 bits, double-and-add from the top."""
        bits = self.decomposition(scalar, 252)
        acc = (ZERO, ONE)
        for bit in reversed(bits):
            acc = self.add_point(acc, acc)
            acc = self.add_point(acc, self.select_identity(bit, p))
        return acc

    def mul_generator(self, scalar: int, generator) -> tuple[int, int]:
        """component_mul_generator: 256 fixed-base gates, gate i reading
        [2^(255 - i)] generator as q_l = x, q_r = y, q_c = x y; the first
        accumulators set to (0, 1) and 0, the last carried by an
        arithmetic row, its scalar set equal to `scalar`."""
        multiples = [generator]
        for _ in range(255):
            multiples.append(jubjub.double(multiples[-1]))
        multiples.reverse()
        for i, (x, y) in enumerate(multiples):
            acc_x, acc_y, acc_bit = (self.witness() for _ in range(3))
            if i == 0:
                self.assert_equal_constant(acc_x, 0)
                self.assert_equal_constant(acc_y, 1)
                self.assert_equal_constant(acc_bit, 0)
            xy_alpha = self.witness()
            self.gate((0, x, y, 0, 0, x * y),
                      (acc_x, acc_y, xy_alpha, acc_bit), family=FIXED_BASE)
        acc_x, acc_y, acc_bit = (self.witness() for _ in range(3))
        self.gate(NO_Q, (acc_x, acc_y, ZERO, acc_bit))
        self.assert_equal(acc_bit, scalar)
        return acc_x, acc_y

    # -- the Hades gadget (dusk-poseidon hades/permutation/gadget.rs) --------
    def _s_box(self, w: int) -> int:
        w2 = self.gate_add((1, 0, 0, 0, 0), w, w)
        w4 = self.gate_add((1, 0, 0, 0, 0), w2, w2)
        return self.gate_add((1, 0, 0, 0, 0), w4, w)

    def _mds(self, r: int, s: list[int]) -> list[int]:
        out = []
        for j in range(WIDTH):
            c = (ROUND_CONSTANTS[r + 1][j]
                 if r + 1 < FULL_ROUNDS + PARTIAL_ROUNDS else 0)
            m = MDS_MATRIX[j]
            first = self.gate_add((0, m[0], m[1], m[2], 0), s[0], s[1], s[2])
            out.append(self.gate_add((0, m[3], m[4], 1, c), s[3], s[4],
                                     first))
        return out

    def permute(self, s: list[int]) -> list[int]:
        half = FULL_ROUNDS // 2
        for r in range(FULL_ROUNDS + PARTIAL_ROUNDS):
            if r == 0:  # the only round whose constants are not folded
                s = [self.gate_add((0, 1, 0, 0, ROUND_CONSTANTS[0][i]), w)
                     for i, w in enumerate(s)]
            if half <= r < half + PARTIAL_ROUNDS:
                s = s[:-1] + [self._s_box(s[-1])]
            else:
                s = [self._s_box(w) for w in s]
            s = self._mds(r, s)
        return s

    def hash(self, inputs: list[int], domain: int = 0) -> int:
        """HashGadget::digest(domain, inputs)[0]: the SAFE sponge's tag
        (absorb len(inputs), squeeze 1) as a constant, the inputs added to
        the rate (input on a, state on b) with a permutation before each
        fifth, and one permutation to squeeze."""
        tag = self.constant(hash_to_scalar(io_tag_bytes(len(inputs), 1,
                                                        domain)))
        state = [tag] + [ZERO] * (WIDTH - 1)
        pos = 0
        for x in inputs:
            if pos == WIDTH - 1:
                state, pos = self.permute(state), 0
            state[pos + 1] = self.gate_add((0, 1, 1, 0, 0), x, state[pos + 1])
            pos += 1
        return self.permute(state)[1]

    def hash_truncated(self, inputs: list[int], domain: int = 0) -> int:
        """HashGadget::digest_truncated: the digest XOR 0 over 125 bit
        pairs, so its top bits are dropped."""
        return self.logic(self.hash(inputs, domain), ZERO, 125, xor=True)

    def merkle4(self, children: list[int]) -> int:
        """HashGadget::digest(Domain::Merkle4, children)[0]."""
        return self.hash(children, MERKLE4_DOMAIN)

    # -- poseidon-merkle zk.rs: the opening gadget --------------------------
    def opening(self, height: int, leaf: int) -> int:
        bits = [[ZERO] * ARITY for _ in range(height)]
        items = [[ZERO] * ARITY for _ in range(height)]
        for level in range(height - 1, -1, -1):
            for i in range(ARITY):
                bits[level][i] = self.witness()
                items[level][i] = self.witness()
                self.boolean(bits[level][i])
            b = bits[level]
            s = self.gate_add((0, 1, 1, 1, 0), b[0], b[1], b[2])
            s = self.gate_add((0, 1, 1, 0, 0), s, b[3])
            self.assert_equal_constant(s, 1)
        current = leaf
        for level in range(height - 1, -1, -1):
            for i in range(ARITY):
                bit = bits[level][i]
                level_hash = self.gate_add((1, 0, 0, 0, 0), bit,
                                           items[level][i])
                current_hash = self.gate_add((1, 0, 0, 0, 0), bit, current)
                self.assert_equal(level_hash, current_hash)
            current = self.merkle4(items[level])
        return current


def opening_circuit(height: int, openings: int) -> Layout:
    """`openings` Merkle memberships in one circuit: for each, the leaf's
    witness, the opening gadget and a gate that sets the computed root
    equal to a public input (merkle-plonk's OpeningCircuit for one)."""
    lay = Layout()
    for _ in range(openings):
        leaf = lay.witness()
        root = lay.opening(height, leaf)
        lay.assert_public(root)
    return lay


def domain_size(constraints: int) -> int:
    return 1 if constraints <= 1 else 1 << (constraints - 1).bit_length()


def columns(lay: Layout, n: int) -> dict[str, list[int]]:
    """The 15 columns on the domain of size n: the selectors (zero past the
    last gate) and the sigma permutations' values k_wire omega^gate."""
    cols = {name: [0] * n for name in SELECTORS}
    for i, (q, family) in enumerate(zip(lay.gates, lay.families)):
        for name, v in zip(SELECTORS, q + family):
            cols[name][i] = v
    # copy constraints: each witness's wire uses form one cycle
    uses = [[] for _ in range(lay.witnesses)]
    for gate, wires in enumerate(lay.wires):
        for kind, w in enumerate(wires):
            uses[w].append((kind, gate))
    sigma = [[(kind, gate) for gate in range(n)] for kind in range(4)]
    for cycle in uses:
        for j, (kind, gate) in enumerate(cycle):
            sigma[kind][gate] = cycle[(j + 1) % len(cycle)]
    omega = root_of_unity(n)
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * omega % R
    ks = (1, K1, K2, K3)
    for kind, name in enumerate(SIGMAS):
        cols[name] = [ks[k] * roots[gate] % R for k, gate in sigma[kind]]
    return cols


def lagrange_at(tau: int, n: int) -> list[int]:
    """L_j(tau) = omega^j (tau^n - 1) / (n (tau - omega^j)), j < n."""
    omega = root_of_unity(n)
    roots = [1] * n
    for i in range(1, n):
        roots[i] = roots[i - 1] * omega % R
    inv = batch_inverse([(tau - w) % R for w in roots])
    c = (pow(tau, n, R) - 1) * pow(n, -1, R) % R
    return [c * w % R * i % R for w, i in zip(roots, inv)]


def verifier_key(lay: Layout, tau: int, g) -> dict[str, object]:
    """The 15 commitments of the verifier key (affine points, None for the
    identity) and `n`, the number of gates."""
    n = domain_size(len(lay.gates))
    cols = columns(lay, n)
    basis = lagrange_at(tau, n)
    vk = {"n": len(lay.gates)}
    for name, col in cols.items():
        if all(v == col[0] for v in col):
            vk[name] = None
        else:
            vk[name] = curve.mul(g, sum(v * l for v, l in zip(col, basis)) % R)
    return vk
