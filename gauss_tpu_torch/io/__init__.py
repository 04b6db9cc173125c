"""Matrix I/O: the ``.dat`` coordinate format and the synthetic generators
(numpy only; the port's own copies)."""
