"""Hölder-Brascamp-Lieb machinery (paper §2.3, Thm 2.4, Prop 2.5).

Given array-access homomorphisms phi_j : Z^d -> Z^{d_j} (as integer matrices),
we generate the subgroup lattice spanned by their kernels (closed under sum and
intersection), emit the rank constraints

    rank(H) <= sum_j s_j * rank(phi_j(H))    for each H in Lattice(ker phi_j)

and solve the LP minimizing sum_j s_j. By Prop 2.5 checking the lattice
suffices; the optimum s = sum_j s_j yields the asymptotic communication lower
bound  Omega(G / M^{s-1}).

All linear algebra is exact over Q (fractions.Fraction), matrices are tiny
(d <= 9), so this costs microseconds. The port of ``repro.core.hbl``, line
for line.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

import numpy as np
from scipy.optimize import linprog

Matrix = Tuple[Tuple[Fraction, ...], ...]  # rows


def _to_matrix(rows: Sequence[Sequence[int]]) -> Matrix:
    return tuple(tuple(Fraction(x) for x in row) for row in rows)


def rref(rows: Sequence[Sequence[Fraction]]) -> List[List[Fraction]]:
    """Reduced row-echelon form over Q; returns the nonzero rows."""
    m = [list(r) for r in rows]
    if not m:
        return []
    nrows, ncols = len(m), len(m[0])
    pivot_row = 0
    for col in range(ncols):
        # find pivot
        sel = None
        for r in range(pivot_row, nrows):
            if m[r][col] != 0:
                sel = r
                break
        if sel is None:
            continue
        m[pivot_row], m[sel] = m[sel], m[pivot_row]
        pv = m[pivot_row][col]
        m[pivot_row] = [x / pv for x in m[pivot_row]]
        for r in range(nrows):
            if r != pivot_row and m[r][col] != 0:
                f = m[r][col]
                m[r] = [a - f * b for a, b in zip(m[r], m[pivot_row])]
        pivot_row += 1
        if pivot_row == nrows:
            break
    return [row for row in m[:pivot_row] if any(x != 0 for x in row)]


def rank(rows: Sequence[Sequence[Fraction]]) -> int:
    return len(rref(rows))


def nullspace(rows: Sequence[Sequence[Fraction]], dim: int) -> List[List[Fraction]]:
    """Basis (as row vectors of length ``dim``) of the kernel of the map whose
    matrix rows are ``rows``."""
    R = rref(rows)
    pivots: List[int] = []
    for row in R:
        for j, x in enumerate(row):
            if x != 0:
                pivots.append(j)
                break
    free = [j for j in range(dim) if j not in pivots]
    basis = []
    for f in free:
        v = [Fraction(0)] * dim
        v[f] = Fraction(1)
        # back-substitute: each pivot row gives pivot_col value
        for row, p in zip(R, pivots):
            v[p] = -row[f]
        basis.append(v)
    return basis


class Subspace:
    """A subspace of Q^d with a canonical (RREF) basis -> hashable."""

    __slots__ = ("dim", "basis", "_key")

    def __init__(self, dim: int, vectors: Sequence[Sequence[Fraction]]):
        self.dim = dim
        self.basis = rref(vectors)
        self._key = tuple(tuple(r) for r in self.basis)

    @property
    def rank(self) -> int:
        return len(self.basis)

    def __eq__(self, other) -> bool:
        return isinstance(other, Subspace) and self._key == other._key

    def __hash__(self) -> int:
        return hash(self._key)

    def __repr__(self) -> str:
        return f"Subspace(rank={self.rank}, basis={self.basis})"

    def sum(self, other: "Subspace") -> "Subspace":
        return Subspace(self.dim, list(self.basis) + list(other.basis))

    def intersect(self, other: "Subspace") -> "Subspace":
        """V cap W via the kernel of [A; B]-coordinates trick:
        x in V cap W  <=>  x = a^T A = b^T B. Solve [A^T | -B^T] y = 0."""
        if not self.basis or not other.basis:
            return Subspace(self.dim, [])
        A, B = self.basis, other.basis
        # unknowns: coefficients (a_1..a_k, b_1..b_l); equations: one per dim
        k, l = len(A), len(B)
        rows = []
        for j in range(self.dim):
            rows.append([A[i][j] for i in range(k)] + [-B[i][j] for i in range(l)])
        ns = nullspace(rows, k + l)
        vecs = []
        for y in ns:
            v = [Fraction(0)] * self.dim
            for i in range(k):
                for j in range(self.dim):
                    v[j] += y[i] * A[i][j]
            vecs.append(v)
        return Subspace(self.dim, vecs)


class Homomorphism:
    """phi : Z^d -> Z^{dj} given by an integer matrix (dj x d), row-acting."""

    def __init__(self, rows: Sequence[Sequence[int]], name: str = "phi"):
        self.mat = _to_matrix(rows)
        self.name = name
        self.dj = len(self.mat)
        self.d = len(self.mat[0]) if self.mat else 0

    def kernel(self) -> Subspace:
        return Subspace(self.d, nullspace(self.mat, self.d))

    def image_rank(self, H: Subspace) -> int:
        """rank of phi(H): apply the matrix to each basis vector of H."""
        imgs = []
        for v in H.basis:
            imgs.append([sum(self.mat[i][j] * v[j] for j in range(self.d)) for i in range(self.dj)])
        return rank(imgs)

    def __repr__(self) -> str:
        return f"Homomorphism({self.name}: Z^{self.d} -> Z^{self.dj})"


def subgroup_lattice(generators: Sequence[Subspace], max_size: int = 4096) -> List[Subspace]:
    """Close a family of subspaces under pairwise sum and intersection
    (Prop 2.5: these are the only subgroups whose rank constraints matter)."""
    seen = set(generators)
    frontier = list(generators)
    while frontier:
        new: List[Subspace] = []
        items = list(seen)
        for a in frontier:
            for b in items:
                for c in (a.sum(b), a.intersect(b)):
                    if c.rank and c not in seen:
                        seen.add(c)
                        new.append(c)
                        if len(seen) > max_size:
                            raise RuntimeError("lattice closure exploded")
        frontier = new
    return sorted(seen, key=lambda s: (s.rank, s._key))


def hbl_constraints(phis: Sequence[Homomorphism]) -> List[Tuple[int, Tuple[int, ...]]]:
    """All (rank(H), (rank phi_j(H))_j) pairs over the kernel lattice, deduped.
    The ambient space Z^d is always included: for injective maps the kernel
    lattice is trivial but the full-space rank constraint still binds."""
    d = phis[0].d
    full = Subspace(d, [[Fraction(int(i == j)) for j in range(d)]
                        for i in range(d)])
    lat = subgroup_lattice([phi.kernel() for phi in phis] + [full])
    out = set()
    for H in lat:
        out.add((H.rank, tuple(phi.image_rank(H) for phi in phis)))
    return sorted(out)


def solve_exponents(
    phis: Sequence[Homomorphism],
    weights: Sequence[float] | None = None,
) -> Tuple[np.ndarray, float]:
    """Solve  min sum_j w_j s_j  s.t. the HBL rank constraints and 0<=s_j<=1.

    Returns (s, sum_j s_j). The minimal *unweighted* sum gives the exponent in
    the Omega(G / M^{s-1}) communication bound.
    """
    cons = hbl_constraints(phis)
    m = len(phis)
    c = np.asarray(weights if weights is not None else [1.0] * m, dtype=float)
    A_ub, b_ub = [], []
    for rk_H, rk_imgs in cons:
        if rk_H == 0:
            continue
        A_ub.append([-r for r in rk_imgs])
        b_ub.append(-rk_H)
    res = linprog(c, A_ub=np.asarray(A_ub, float), b_ub=np.asarray(b_ub, float),
                  bounds=[(0.0, 1.0)] * m, method="highs")
    if not res.success:
        raise RuntimeError(f"HBL exponent LP infeasible: {res.message}")
    s = res.x
    return s, float(np.sum(s))


# ---------------------------------------------------------------------------
# The paper's homomorphisms.
# ---------------------------------------------------------------------------

def conv7nl_phis(sw: int = 1, sh: int = 1) -> List[Homomorphism]:
    """phi_I, phi_F, phi_O for 7NL CNN over indices (i1..i7) (paper §3.1):

        phi_I(i) = (i1, i2, i6 + sw*i4, i7 + sh*i5)
        phi_F(i) = (i2, i3, i6, i7)
        phi_O(i) = (i1, i3, i4, i5)
    """
    phi_I = Homomorphism(
        [
            [1, 0, 0, 0, 0, 0, 0],
            [0, 1, 0, 0, 0, 0, 0],
            [0, 0, 0, sw, 0, 1, 0],
            [0, 0, 0, 0, sh, 0, 1],
        ],
        name="phi_I",
    )
    phi_F = Homomorphism(
        [
            [0, 1, 0, 0, 0, 0, 0],
            [0, 0, 1, 0, 0, 0, 0],
            [0, 0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 0, 1],
        ],
        name="phi_F",
    )
    phi_O = Homomorphism(
        [
            [1, 0, 0, 0, 0, 0, 0],
            [0, 0, 1, 0, 0, 0, 0],
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 0, 0, 1, 0, 0],
        ],
        name="phi_O",
    )
    return [phi_I, phi_F, phi_O]


def conv7nl_lifted_phis() -> List[Homomorphism]:
    """The small-filter lifted homomorphisms (paper Lemma 3.4) over indices
    (i1, i2, i3, i4, i5, r6, r7) with (q6, q7) held fixed:

        phi'_I = (i1, i2, i4, r6, i5, r7)
        phi'_F = (i2, i3, r6, r7)
        phi'_O = (i1, i3, i4, i5)

    Every index appears in exactly two maps -> tensor-contraction case, optimal
    exponents s = (1/2, 1/2, 1/2).
    """
    phi_I = Homomorphism(
        [
            [1, 0, 0, 0, 0, 0, 0],
            [0, 1, 0, 0, 0, 0, 0],
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 1, 0, 0],
            [0, 0, 0, 0, 0, 0, 1],
        ],
        name="phi_I'",
    )
    phi_F = Homomorphism(
        [
            [0, 1, 0, 0, 0, 0, 0],
            [0, 0, 1, 0, 0, 0, 0],
            [0, 0, 0, 0, 0, 1, 0],
            [0, 0, 0, 0, 0, 0, 1],
        ],
        name="phi_F'",
    )
    phi_O = Homomorphism(
        [
            [1, 0, 0, 0, 0, 0, 0],
            [0, 0, 1, 0, 0, 0, 0],
            [0, 0, 0, 1, 0, 0, 0],
            [0, 0, 0, 0, 1, 0, 0],
        ],
        name="phi_O'",
    )
    return [phi_I, phi_F, phi_O]


def matmul_phis() -> List[Homomorphism]:
    """Loomis-Whitney / 3NL matmul: C[i,k] += A[i,j] B[j,k] over (i, j, k)."""
    return [
        Homomorphism([[1, 0, 0], [0, 1, 0]], name="phi_A"),
        Homomorphism([[0, 1, 0], [0, 0, 1]], name="phi_B"),
        Homomorphism([[1, 0, 0], [0, 0, 1]], name="phi_C"),
    ]


def constraint_table(phis: Sequence[Homomorphism]) -> List[Dict]:
    """Human-readable constraint table (mirrors the paper's §3.1 table)."""
    rows = []
    for rk_H, rk_imgs in hbl_constraints(phis):
        terms = " + ".join(
            f"{r}*s_{phi.name.split('_')[-1]}" for r, phi in zip(rk_imgs, phis) if r
        )
        rows.append({"rank_H": rk_H, "ranks": rk_imgs, "constraint": f"{rk_H} <= {terms}"})
    return rows
