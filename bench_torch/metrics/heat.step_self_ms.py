"""Device self time per steady heat step of the program's
``diffusion_step_axis0`` span: the step less its ``stencil_pass`` and
``stencil_ghosts`` children, that is any copy, cast or gap around the
pass."""

from bench_torch import stencil_work


def read(t):
    return stencil_work.self_ms(t)
