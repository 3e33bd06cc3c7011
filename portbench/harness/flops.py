"""Model FLOPs from the configuration alone, at each item's valid lengths:
the conventions, and the helper that the families' counts
(``families/<name>.py``: ``forward_flops``, ``train_flops``, ``flops``)
share.

Counted as ``torch.utils.flop_counter.FlopCounterMode`` counts the plain
reference: 2·m·n·k for each matrix product and 2·out·in·kernel for each
output position of a convolution (biases, norms, activations, the
softmax, gathers and FFTs are not counted).  A backward counts the product
again for each operand that needs a gradient.  Padding is never counted,
so an implementation that skips it reads as doing more of the model's work
per second.
"""

from __future__ import annotations


def lin(n, i, o):
    """A product of n rows of width i by an (i, o) matrix: a dense layer,
    or a convolution at n output positions with i = in·kernel."""
    return 2 * n * i * o
