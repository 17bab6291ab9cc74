"""Synthetic verifiable math tasks (the port's own copy of the problem
generators of ``repro.data.math_tasks``).

Stands in for OpenR1-Math (SFT) and Big-Math (RL) in the offline
container: problems have a canonical reasoning chain and an exactly
checkable integer answer (the math-verify role).  Format mirrors the
open-math convention the paper trains on:

    Q: 37+18*2=?
    A: 18*2=36. 37+36=73. #### 73

The reward checker parses the text after '####'.
"""

from __future__ import annotations

import dataclasses
import random


@dataclasses.dataclass
class MathProblem:
    question: str
    reasoning: str
    answer: int

    @property
    def prompt(self) -> str:
        return f"Q: {self.question}\nA:"

    @property
    def full(self) -> str:
        return f"{self.prompt} {self.reasoning} #### {self.answer}"


def _gen_add_small(rng: random.Random) -> MathProblem:
    """Level 0: single-digit sums — learnable by tiny CPU demo models."""
    a, b = rng.randint(1, 9), rng.randint(1, 9)
    return MathProblem(f"{a}+{b}=?", f"{a}+{b}={a + b}.", a + b)


def _gen_add(rng: random.Random) -> MathProblem:
    a, b = rng.randint(10, 999), rng.randint(10, 999)
    return MathProblem(f"{a}+{b}=?", f"{a}+{b}={a + b}.", a + b)


def _gen_sub(rng: random.Random) -> MathProblem:
    a, b = rng.randint(10, 999), rng.randint(10, 999)
    a, b = max(a, b), min(a, b)
    return MathProblem(f"{a}-{b}=?", f"{a}-{b}={a - b}.", a - b)


def _gen_mul(rng: random.Random) -> MathProblem:
    a, b = rng.randint(2, 99), rng.randint(2, 9)
    return MathProblem(f"{a}*{b}=?", f"{a}*{b}={a * b}.", a * b)


def _gen_mix(rng: random.Random) -> MathProblem:
    a, b, c = rng.randint(2, 99), rng.randint(2, 20), rng.randint(2, 9)
    mid = b * c
    ans = a + mid
    return MathProblem(f"{a}+{b}*{c}=?",
                       f"{b}*{c}={mid}. {a}+{mid}={ans}.", ans)


def _gen_linear(rng: random.Random) -> MathProblem:
    x = rng.randint(2, 30)
    a = rng.randint(2, 9)
    b = rng.randint(1, 50)
    c = a * x + b
    return MathProblem(f"{a}x+{b}={c}, x=?",
                       f"{a}x={c}-{b}={c - b}. x={c - b}//{a}={x}.", x)


GENERATORS = [_gen_add_small, _gen_add, _gen_sub, _gen_mul, _gen_mix,
              _gen_linear]


def sample_problem(rng: random.Random, level: int | None = None
                   ) -> MathProblem:
    gens = GENERATORS if level is None else GENERATORS[:level + 1]
    return rng.choice(gens)(rng)
