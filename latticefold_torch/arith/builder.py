"""R1CS constraint-system builder (frontend authoring API).

Capability-parity with the reference's builder
(crates/latticefold/src/arith/r1cs.rs:309-602):
``LinearCombination`` (coefficient, variable-index terms), ``Constraint``
(a * b = c), ``ConstraintSystem`` (validate, satisfy-check, A/B swap
heuristic, conversion to the sparse R1CS), and ``VariableMap`` (named
variable ranges). Coefficients are F_q ints or host ring elements, matching
arith/sparse.SparseMatrix's coefficient model.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ..rings.construct import Ring
from .ccs import R1CS
from .sparse import SparseMatrix


@dataclass
class LinearCombination:
    """terms: list of (coeff, var index) (r1cs.rs:309-358)."""

    terms: List[Tuple] = field(default_factory=list)

    @classmethod
    def single_term(cls, coeff, index: int) -> "LinearCombination":
        return cls([(coeff, index)])

    def add_term(self, coeff, index: int) -> "LinearCombination":
        self.terms.append((coeff, index))
        return self

    def add_terms(self, terms) -> "LinearCombination":
        self.terms.extend(terms)
        return self

    def evaluate(self, ring: Ring, assignment: list):
        acc = ring.zero()
        for coeff, idx in self.terms:
            c = ring.embed_int(coeff) if isinstance(coeff, int) else coeff
            acc = ring.radd(acc, ring.rmul(c, assignment[idx]))
        return acc

    def is_valid(self, nvars: int) -> bool:
        return all(idx < nvars for _, idx in self.terms)


@dataclass
class Constraint:
    """a * b = c (r1cs.rs:361-377)."""

    a: LinearCombination
    b: LinearCombination
    c: LinearCombination


class NotSatisfiedError(Exception):
    def __init__(self, index: int):
        super().__init__(f"constraint {index} not satisfied")
        self.index = index


@dataclass
class VariableMap:
    """Named variable ranges (r1cs.rs:555-602)."""

    map: Dict[str, Tuple[int, int]] = field(default_factory=dict)
    one: int = 0
    total_len: int = 1

    def add(self, name: str, index: int, length: int):
        self.map[name] = (index, length)
        self.total_len += length

    def get(self, name: str) -> Optional[Tuple[int, int]]:
        return self.map.get(name)

    def set_one(self, index: int) -> int:
        self.one = index
        return index

    def get_one(self) -> int:
        return self.one

    def vars(self):
        return iter(sorted(self.map.items()))


@dataclass
class ConstraintSystem:
    """r1cs.rs:380-552."""

    ring: Ring
    ninputs: int = 0
    nauxs: int = 0
    constraints: List[Constraint] = field(default_factory=list)
    vars: VariableMap = field(default_factory=VariableMap)

    @property
    def nvars(self) -> int:
        return self.ninputs + self.nauxs

    @property
    def nconstraints(self) -> int:
        return len(self.constraints)

    def add_constraint(self, constraint: Constraint) -> "ConstraintSystem":
        self.constraints.append(constraint)
        return self

    def is_valid(self) -> bool:
        if self.ninputs > self.nvars:
            return False
        return all(
            c.a.is_valid(self.nvars) and c.b.is_valid(self.nvars) and c.c.is_valid(self.nvars)
            for c in self.constraints
        )

    def is_satisfied(self, primary_input: list, auxiliary_input: list):
        """Raises NotSatisfiedError (with the failing index) or ValueError."""
        if len(primary_input) != self.ninputs:
            raise ValueError(
                f"primary_input length {len(primary_input)} != ninputs {self.ninputs}"
            )
        if len(primary_input) + len(auxiliary_input) != self.nvars:
            raise ValueError(
                f"assignment length {len(primary_input) + len(auxiliary_input)}"
                f" != nvars {self.nvars}"
            )
        assignment = list(primary_input) + list(auxiliary_input)
        for i, c in enumerate(self.constraints):
            a = c.a.evaluate(self.ring, assignment)
            b = c.b.evaluate(self.ring, assignment)
            cc = c.c.evaluate(self.ring, assignment)
            if self.ring.rmul(a, b) != cc:
                raise NotSatisfiedError(i)

    def swap_AB_if_beneficial(self):
        """r1cs.rs:484-507: put the denser side in A."""
        touched_a = set()
        touched_b = set()
        for c in self.constraints:
            touched_a.update(i for _, i in c.a.terms)
            touched_b.update(i for _, i in c.b.terms)
        if len(touched_b) > len(touched_a):
            for c in self.constraints:
                c.a, c.b = c.b, c.a

    def to_r1cs(self) -> R1CS:
        """r1cs.rs:510-551."""
        rows_a = [list(c.a.terms) for c in self.constraints]
        rows_b = [list(c.b.terms) for c in self.constraints]
        rows_c = [list(c.c.terms) for c in self.constraints]
        n, m = self.nvars, self.nconstraints
        return R1CS(
            l=self.ninputs,
            A=SparseMatrix(self.ring, m, n, rows_a),
            B=SparseMatrix(self.ring, m, n, rows_b),
            C=SparseMatrix(self.ring, m, n, rows_c),
        )
