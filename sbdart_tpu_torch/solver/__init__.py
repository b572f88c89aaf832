"""Discrete-ordinates radiative-transfer solver core (torch).

The public entry point is :func:`sbdart_tpu_torch.solver.disort.solve_rte`.
"""
