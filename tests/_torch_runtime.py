"""Shared helpers of the runtime-services port tests
(`test_torch_costmodel.py`, `test_torch_profile.py`,
`test_torch_autotune.py`, `test_torch_faults.py`): both packages side by
side, and the reset of the port's process-wide state."""

import numpy as np

import tensorframes_tpu as tfs
import tensorframes_tpu_torch as tft
from tensorframes_tpu import config as jconfig
from tensorframes_tpu.runtime import faults as jfaults
from tensorframes_tpu.testing import faults as jchaos
from tensorframes_tpu_torch import config as tconfig
from tensorframes_tpu_torch.runtime import faults as tfaults
from tensorframes_tpu_torch.testing import faults as tchaos

CPU = "cpu"

# per package: the module, its config, fault ledger, injection harness and
# the verb keyword that puts the port on the CPU
SIDES = {
    "jax": dict(pkg=tfs, config=jconfig, faults=jfaults, chaos=jchaos, dev={}),
    "torch": dict(pkg=tft, config=tconfig, faults=tfaults, chaos=tchaos, dev={"device": CPU}),
}

FAST_RETRY = dict(retry_backoff_base_s=0.001, retry_backoff_max_s=0.002)


def host(x):
    """A verb result (tensor, jax array, column values) as numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def reset_port() -> None:
    """Every piece of the port's process-wide runtime state these tests
    touch."""
    from tensorframes_tpu_torch import globalframe as tglobal
    from tensorframes_tpu_torch.graph import plan as tplan
    from tensorframes_tpu_torch.graph import vectorize as tvec
    from tensorframes_tpu_torch.runtime import autotune as tautotune
    from tensorframes_tpu_torch.runtime import blackbox as tblackbox
    from tensorframes_tpu_torch.runtime import costmodel as tcost
    from tensorframes_tpu_torch.runtime import deadline as tdl
    from tensorframes_tpu_torch.runtime import scheduler as tsched
    from tensorframes_tpu_torch.utils import profiling as tprof
    from tensorframes_tpu_torch.utils import telemetry as ttele

    tautotune.reset()
    tconfig.reset_tuning()
    tft.serving.reset()
    ttele.shutdown()
    ttele.reset()
    tfaults.reset_ledger()
    tcost.reset()
    tdl.reset()
    tblackbox.reset_state()
    tplan.reset_state()
    tvec.reset_state()
    tsched.device_health().reset()
    tglobal.reset_state()
    tprof.reset_stats()
    ttele._event_pool.clear()
