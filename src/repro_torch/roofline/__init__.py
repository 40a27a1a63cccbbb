"""Roofline accounting of the port's steps on one H100: the hardware's
peaks and the three-term roofline (``analysis``), and the counts of an
eager step (``accounting``), the port's counterparts of the JAX
package's ``repro.roofline``."""

from repro_torch.roofline.analysis import (  # noqa: F401
    HW,
    Hardware,
    model_flops,
    roofline_terms,
)
