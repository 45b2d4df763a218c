"""The system under test: the port, ``plutus_halo2_tpu_torch``, set up for a
cell. The benchmark takes from it only its verifier, its entry points and
its kernels' names.

The port's plan is built by the port from the configuration's committed VK
and the port's own circuit structure for the set (``config["port_set"]``
in the port's ``utils/artifacts.SETS``); the inputs are the benchmark's."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class Batch:
    """One layout's inputs as the port's entry points take them: CPU
    tensors, which reach the card through the port's own staging."""

    proofs: torch.Tensor
    pis: torch.Tensor
    hints: torch.Tensor | None
    rlc_weights: torch.Tensor | None


def verifier(config: dict, traffic: dict, vk_json: str, device):
    from plutus_halo2_tpu_torch.models.verifier_torch import TorchVerifier
    from plutus_halo2_tpu_torch.refimpl.keygen import plan_from_vk
    from plutus_halo2_tpu_torch.utils.artifacts import SETS
    from plutus_halo2_tpu_torch.utils.serialization import vk_from_json

    _directory, circuit, flavor = SETS[config["port_set"]]
    plan = plan_from_vk(circuit(), vk_from_json(vk_json), flavor=flavor)
    return TorchVerifier(plan, device=device, subgroup_check=traffic["subgroup"],
                         subgroup_rounds=int(traffic["subgroup_rounds"]))


class Readback:
    """Host copies of a call's outputs, queued on the current stream right
    behind the call (pinned memory, without blocking), so that reading them
    waits for that call alone and not for the calls issued after it: a
    caller keeping two calls in flight has the card run one while it reads
    the other. Tensors on the CPU are taken as they are."""

    def __init__(self, tensors):
        self.host = [t if t.device.type == "cpu" else
                     torch.empty(t.shape, dtype=t.dtype, pin_memory=True).copy_(t, non_blocking=True)
                     for t in tensors]
        self.done = None
        if any(t.device.type != "cpu" for t in tensors):
            self.done = torch.cuda.Event(blocking=True)  # the waiting host thread sleeps, not spins
            self.done.record()

    def wait(self) -> list:
        if self.done is not None:
            self.done.synchronize()
        return self.host


def batches(gen) -> list[Batch]:
    """Every layout of the generated traffic as CPU tensors."""
    pis = torch.from_numpy(gen.pis)
    return [Batch(torch.from_numpy(lay.proofs), pis,
                  None if lay.hints is None else torch.from_numpy(lay.hints),
                  None if lay.rlc_weights is None else torch.from_numpy(lay.rlc_weights))
            for lay in gen.layouts]
