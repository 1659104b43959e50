"""The inline PTX of a CUDA header, parsed and executed on the CPU.

The design tests of the hand-written kernels (`test_torch_padd_design.py`,
`test_torch_hades_design.py`) do not rewrite the headers' carry chains in
Python: they read every function whose body holds one asm statement out of
the header and execute its instructions on 32-bit words with an explicit
carry flag.  Known instructions: mad / madc (lo, hi), add / addc, sub / subc,
with or without `.cc`, on `u32`.
"""

import re

M32 = 0xFFFFFFFF

_CHAIN = re.compile(
    r"__device__ __forceinline__ \w+ (\w+)\(([^)]*)\) \{(?:[^{}]*?)"
    r"asm\(((?:\s*\"[^\"]*\")+)\s*:([^:;]*):([^:;]*)\);", re.S)


class Chain:
    """One asm statement: the function's parameter names, its instructions
    as text, its operand expressions, and the instructions compiled to
    (kind, sets the flag, destination, sources) with every operand resolved
    to (name, index or None) or an immediate."""

    def __init__(self, names, instrs, operands):
        self.names, self.instrs, self.operands = names, instrs, operands
        self.program = [self._compile(ins) for ins in instrs]

    def _ref(self, tok):
        if not tok.startswith("%"):
            return int(tok)
        expr = self.operands[int(tok[1:])]
        m = re.fullmatch(r"(\w+)\[(\d+)\]", expr)
        return (m.group(1), int(m.group(2))) if m else (expr, None)

    def _compile(self, ins):
        op, rest = ins.split(None, 1)
        toks = [t.strip() for t in rest.split(",")]
        parts = op.split(".")
        assert parts[-1] == "u32", ins
        base = parts[0]
        if base in ("mad", "madc"):
            kind = ("mul_" + parts[1], base == "madc")
        elif base in ("add", "addc"):
            kind = ("add", base == "addc")
        elif base in ("sub", "subc"):
            kind = ("sub", base == "subc")
        else:
            raise AssertionError(f"unknown instruction {ins}")
        return (kind, "cc" in parts, self._ref(toks[0]),
                [self._ref(t) for t in toks[1:]])


def parse_chains(text: str) -> dict:
    """name -> Chain of every function of the header whose body holds one
    asm statement."""
    chains = {}
    for name, params, strings, outs, ins in _CHAIN.findall(text):
        code = "".join(re.findall(r"\"([^\"]*)\"", strings))
        code = code.replace("\\n\\t", "")
        instrs = [i.strip() for i in code.split(";") if i.strip()]
        operands = re.findall(r"\"[+=]?r\"\(([^)]*)\)", outs + "," + ins)
        names = [p.split()[-1].lstrip("*&") for p in params.split(",")]
        chains[name] = Chain(names, instrs, operands)
    return chains


def run_chain(chains: dict, name: str, *args):
    """Execute the asm statement of `name` on Python lists of 32-bit words
    (arrays, updated in place) and ints (scalars).  A scalar operand that is
    no parameter (a local the statement only writes) starts at 0.  Returns
    (the scalars after the statement, whether the LAST instruction
    wrapped)."""
    chain = chains[name]
    env = dict(zip(chain.names, args))
    for _, _, dst, _ in chain.program:
        if dst[1] is None and dst[0] not in env:
            env[dst[0]] = 0

    def get(ref):
        if isinstance(ref, int):
            return ref
        key, idx = ref
        return env[key] if idx is None else env[key][idx]

    carry = 0
    wrapped = False
    for (kind, with_carry), sets, dst, src in chain.program:
        if kind == "add":
            total = get(src[0]) + get(src[1]) + (carry if with_carry else 0)
        elif kind == "sub":
            total = get(src[0]) - get(src[1]) - (carry if with_carry else 0)
        else:
            prod = get(src[0]) * get(src[1])
            prod = prod & M32 if kind == "mul_lo" else prod >> 32
            total = prod + get(src[2]) + (carry if with_carry else 0)
        wrapped = not 0 <= total <= M32
        if sets:
            carry = 1 if wrapped else 0
        if dst[1] is None:
            env[dst[0]] = total & M32
        else:
            env[dst[0]][dst[1]] = total & M32
    return {k: v for k, v in env.items() if not isinstance(v, list)}, wrapped


def check_operands_all_used(chains: dict, limit: int = 30) -> None:
    """Every operand of every statement is named by some instruction, and
    none has more operands than an asm statement takes."""
    for name, chain in chains.items():
        assert len(chain.operands) <= limit, name
        used = {int(t) for i in chain.instrs
                for t in re.findall(r"%(\d+)", i)}
        assert used == set(range(len(chain.operands))), name


def function_body(text: str, name: str) -> str:
    """The source of the header's function `name`, between its braces."""
    start = re.search(r"\b(?:void|uint32_t) %s\([^)]*\) \{" % name, text).end()
    depth, i = 1, start
    while depth:
        depth += {"{": 1, "}": -1}.get(text[i], 0)
        i += 1
    return text[start:i - 1]


def calls(body: str, name: str) -> list[str]:
    """The argument lists of every call of `name` in `body`, in order."""
    return re.findall(r"\b%s\(([^;]*)\);" % name, body)
