"""Structure detection (:mod:`.detect`) and the pieces of the structured
solvers that the sparse plane uses: the typed ``NotSPDError``
(:mod:`.cholesky`) and the tridiagonal solve (:mod:`.banded`). The
structured factorizations and the router are not ported yet."""
