"""Guest programs used by the port's tests, golden fixtures and chip smoke
run: the five guests of the JAX package's test_artifacts.py (reference
crates/test-artifacts/guests/*.bf), the uni-STARK golden guest, and the
bench guest."""

from __future__ import annotations

# Cpu-chip golden fixture: doubles its input byte in a loop (1020 cycles ->
# a 1024-row trace); tests/golden/uni_cpu_double44_q84.json holds the JAX
# package's uni-STARK proof of it at 84 queries (tools/make_uni_golden.py).
GOLDEN_NAME = "double44"
GOLDEN_SOURCE = ",[->+>++<<]>>[-<<+>>]<<."
GOLDEN_INPUT = bytes([44])
GOLDEN_QUERIES = 84


def bench_guest(log2_cycles: int) -> str:
    """Guest with EXACTLY 2^k - 1 cycles -> a 2^k-row Cpu trace (the
    composition of the repo's bench.py): m loop units '-[>-[-]<-]' (255
    outer iterations of a 255-iteration inner clear loop, 131_582 cycles)
    plus a straight-line '+-' filler and one output."""
    unit = "-[>-[-]<-]"
    unit_cycles = 131_582
    target = (1 << log2_cycles) - 1
    m = max(0, (target - 1) // unit_cycles)
    rest = target - 1 - unit_cycles * m
    q, r = divmod(rest, 2)
    return unit * m + "+-" * q + "+" * r + "."


# Reads n, prints fib-style multiply/add result (README's multiplication demo):
FIBO_BF = ",>+>+<<[->>[->+>+<<]<[->>+<<]>>[-<+>]>[-<<<+>>>]<<<<]>>."

HELLO_BF = (
    ">++++++++[<+++++++++>-]<.>++++[<+++++++>-]<+.+++++++..+++."
    ">>++++++[<+++++++>-]<+"
)

MOVE_BF = ">>>>++.<<<<."

LOOP_BF = "+++++[-]."

PRINTA_BF = """+++++ +++++
+++++ +++++
+++++ +++++
+++++ +++++
+++++ +++++
+++++ +++++
+++++
."""

ALL = {
    "fibo": FIBO_BF,
    "hello": HELLO_BF,
    "move": MOVE_BF,
    "loop": LOOP_BF,
    "printa": PRINTA_BF,
}
