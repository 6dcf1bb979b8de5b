"""Device time per steady heat step in the program's ``stencil_pass``
spans: the one K4 launch of ``diffusion_step``, between two events on its
stream."""

from bench_torch import stencil_work


def read(t):
    return stencil_work.pass_ms(t)
