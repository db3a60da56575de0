"""Contact-MPC on the batched differentiable contact step (counterpart of
``moby_tpu/mpc``): `diffstep` (the step), `ilqr` (batched iLQR) and
`contact_mpc` (state packing and `solve_batch`)."""

from ..solvers.difflcp import MPCOptions  # noqa: F401
