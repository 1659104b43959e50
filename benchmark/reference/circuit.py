"""The Merkle-opening circuit's layout and its verifier key, from the
circuit's definition alone.

The gates follow dusk-plonk's Composer (4 wires a, b, c, d; selectors
q_m q_l q_r q_o q_f q_c q_arith q_range q_logic q_fixed_group_add
q_variable_group_add; a public input is recorded by gate), the Poseidon
gadget of dusk-poseidon (round constants folded into the MDS gates) and
the opening gadget of poseidon-merkle (zk.rs).  Only the structure is
built: which witness sits on which wire and every selector value.  No
witness value enters the verifier key, so none is computed.

The verifier key is each selector and sigma column's commitment
[q(tau)] g, q(tau) taken from the column's values on the domain through
the Lagrange basis at tau; a constant column commits to the identity, as
the compiler's `commit(..).unwrap_or_default()` does.
"""

from __future__ import annotations

from . import curve
from .field import K1, K2, K3, R, batch_inverse, root_of_unity
from .poseidon import FULL_ROUNDS, MERKLE4_TAG, PARTIAL_ROUNDS, WIDTH
from .poseidon_constants import MDS_MATRIX, ROUND_CONSTANTS

SELECTORS = ("q_m", "q_l", "q_r", "q_o", "q_f", "q_c", "q_arith",
             "q_range", "q_logic", "q_fixed_group_add",
             "q_variable_group_add")
SIGMAS = ("s_sigma_1", "s_sigma_2", "s_sigma_3", "s_sigma_4")
ZERO = 0  # the composer's first witness, the constant 0
ARITY = 4


class Layout:
    """Gates of an arithmetic-only circuit: (q_m, q_l, q_r, q_o, q_f, q_c)
    and the wires (a, b, c, d) as witness indices; q_arith is 1 on every
    gate and the other family selectors 0."""

    def __init__(self):
        self.witnesses = 0
        self.gates: list[tuple] = []
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

    def gate(self, q, wires, public: bool = False) -> None:
        if public:
            self.public.append(len(self.gates))
        self.gates.append(tuple(c % R for c in q))
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

    def merkle4(self, children: list[int]) -> int:
        """HashGadget::digest(Domain::Merkle4, children)[0]."""
        tag = self.constant(MERKLE4_TAG)
        state = [tag, ZERO, ZERO, ZERO, ZERO]
        for i, x in enumerate(children):  # input on a, state on b
            state[i + 1] = self.gate_add((0, 1, 1, 0, 0), x, state[i + 1])
        return self.permute(state)[1]

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
        lay.gate((0, -1, 0, 0, 0, 0), (root, ZERO, ZERO, ZERO), public=True)
    return lay


def domain_size(constraints: int) -> int:
    return 1 if constraints <= 1 else 1 << (constraints - 1).bit_length()


def columns(lay: Layout, n: int) -> dict[str, list[int]]:
    """The 15 columns on the domain of size n: the selectors (zero past the
    last gate) and the sigma permutations' values k_wire omega^gate."""
    cols = {name: [0] * n for name in SELECTORS}
    for i, q in enumerate(lay.gates):
        for name, v in zip(SELECTORS, q):
            cols[name][i] = v
        cols["q_arith"][i] = 1
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
