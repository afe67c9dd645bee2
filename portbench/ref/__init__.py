"""The benchmark's plain reference: a frozen copy of the port's plain
PyTorch modules (config, types, geometry, reference_line, world, dp,
corridor, costs, barriers, model, solver, scenario), with the single-problem
solver (``solver.solve``, no kernel) in place of the megakernel, and the few
pipeline and MPC functions the comparison needs in ``stages``.

It imports nothing of ``cilqr_tpu_torch``, ``cilqr_tpu`` or JAX (the tests
and every run check that), so an edit of the program cannot move it. The
copies are the port's files as they stood when the benchmark was written,
less what no comparison reaches: ``solver._select_backward``'s branch into
``pscan``, the solver's history variant, the autodiff Jacobian, the
scenario builders that the benchmark's own inputs replace, the oriented-box
collision probe, the one-time dynamic-point query and the road-less
collision mode.
"""
