"""The port's Pade fitter (`lpcnet_torch.utils.pade`) against the JAX
package's numpy version, on the CPU in float64."""

import numpy as np
import pytest
import torch

from lpcnet_tpu.utils import pade as JP
from lpcnet_torch.utils import pade as P


@pytest.mark.parametrize("orders", [(5, 4), (7, 6), (3, 2)])
def test_fit_pade_odd_matches_numpy(orders):
    jp, jq = JP.fit_pade_odd(np.tanh, *orders)
    p, q = P.fit_pade_odd(torch.tanh, *orders, device="cpu")
    assert p.dtype == q.dtype == torch.float64
    np.testing.assert_allclose(p.numpy(), jp, rtol=0, atol=1e-9)
    np.testing.assert_allclose(q.numpy(), jq, rtol=0, atol=1e-9)
    x = np.linspace(-9.0, 9.0, 777)
    np.testing.assert_allclose(P.eval_pade_odd(torch.from_numpy(x), p, q),
                               JP.eval_pade_odd(x, jp, jq), rtol=0, atol=1e-9)


def test_tanh_pade_error_matches_numpy():
    want = JP.tanh_pade_error()
    got = P.tanh_pade_error(device="cpu")
    assert abs(got - want) <= 1e-12
    assert 0.0 < got < 1e-2


def test_pade_needs_cuda_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        P.fit_pade_odd()
