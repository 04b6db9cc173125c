"""Reference-parity drivers: ``gauss_internal`` and ``gauss_external``."""
