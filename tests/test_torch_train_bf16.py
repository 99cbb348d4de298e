"""`repro_torch.models.lm.train_loss` against the reference's in bf16
compute: loss, MoE aux loss and gradients for the smoke config of every
architecture."""
import numpy as np
import pytest

from repro import configs as jconfigs

from test_torch_train import _port, _reference
from test_torch_util import BF16_TOL

# bf16 rounds at other places in the two frameworks (and a near tie in a
# bf16 MoE router picks another expert), so a bf16 gradient of the port is
# held against the reference's fp32 one: no farther from it, element by
# element, than BF16_GRAD_FACTOR times the reference's own bf16 gradient
# is (the largest ratio over the ten archs' leaves is 1.74)
BF16_GRAD_FACTOR = 3.0


@pytest.mark.parametrize("arch", jconfigs.ARCH_IDS)
def test_train_loss_and_grads_match_reference_bf16(arch):
    loss, aux, grads = _port(arch, "bfloat16")
    jloss, jaux, jgrads = _reference(arch, "bfloat16")
    _, _, exact = _reference(arch, "float32")
    np.testing.assert_allclose(loss, jloss, **BF16_TOL)
    np.testing.assert_allclose(aux, jaux, **BF16_TOL)
    for i, (g, jg, g32) in enumerate(zip(grads, jgrads, exact)):
        theirs = np.abs(jg - g32).max()
        ours = np.abs(g - g32).max()
        assert ours <= BF16_GRAD_FACTOR * theirs, (i, ours, theirs)
