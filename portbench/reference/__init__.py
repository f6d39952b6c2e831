"""The plain reference that decides `correct`.

Plain PyTorch, nothing else: no module of the measured program, no JAX.
It recomputes from the benchmark's own inputs whatever the program derived
(the MO Hamiltonian, the factor-assembled integrals) and reads the
program's outputs only to judge them.  The equations are frozen copies of
the closed-shell spin-adapted CCSD, HBAR, Lambda, (T) and one-particle
density forms (Stanton, Gauss, Watts, Bartlett, JCP 94, 4334 (1991)), with
every particle-particle ladder a plain matrix product.
"""
