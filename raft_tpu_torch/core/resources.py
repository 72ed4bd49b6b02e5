"""Resource registry and device handle.

Port of ``raft_tpu/core/resources.py`` (``raft::resources`` and
``raft::device_resources``). A handle is a lazily filled table of named
slots, each made on first use by the factory registered for its name
(:func:`resource_factory`); a copy shares the slots' objects but not the
table. The port's slots:

* ``device``: an explicit ``torch.device``, ``cuda`` by default. Entry
  points move numpy (and other non-tensor) inputs to it and leave tensors
  where they are, so CPU tensors select the CPU. Asking for ``cuda`` on a
  machine without a card raises: nothing carries on quietly on the CPU;
* ``generator``: a ``torch.Generator`` on the device, seeded from
  ``DeviceResources(seed=)`` (0 by default), in place of the reference's
  PRNG key stream;
* ``comms`` and ``sub_comms``: the injected communicator and named
  sub-communicators.

The reference's ``mesh`` slot is JAX plumbing and has no counterpart.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Union

import numpy as np
import torch

from raft_tpu_torch.core.error import CudaError, LogicError, expects

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``device`` as a ``torch.device`` (``cuda`` when None); raises
    :class:`CudaError` when CUDA is asked for and there is no card."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise CudaError(f"device {dev} requested but CUDA is not available")
    return dev


_FACTORIES: Dict[str, Callable[["Resources"], Any]] = {}


def resource_factory(name: str):
    """Register ``fn(resources)`` as the maker of slot ``name``."""

    def deco(fn: Callable[["Resources"], Any]):
        _FACTORIES[name] = fn
        return fn

    return deco


@resource_factory("device")
def _default_device(res: "Resources") -> torch.device:
    return resolve_device(None)


@resource_factory("generator")
def _default_generator(res: "Resources") -> torch.Generator:
    return torch.Generator(device=res.device).manual_seed(0)


class Resources:
    """Handle over one explicit device (default ``cuda``, resolved at
    construction). ``Resources(other)`` and ``Resources(other=other)`` are
    a shallow copy: it shares the objects of ``other``'s slots, but
    rebinding a slot on the copy leaves ``other`` as it was. Keyword
    ``overrides`` fill slots up front."""

    def __init__(self, device: DeviceLike = None,
                 other: Optional["Resources"] = None, **overrides):
        if isinstance(device, Resources):
            device, other = None, device
        if other is not None:
            self._slots = dict(other._slots)
            if device is not None:
                self._slots["device"] = resolve_device(device)
        else:
            self._slots = {"device": resolve_device(device)}
        for name, value in overrides.items():
            if value is not None:
                self._slots[name] = value

    # -- generic slot access ------------------------------------------------
    def has_resource(self, name: str) -> bool:
        return name in self._slots or name in _FACTORIES

    def get_resource(self, name: str) -> Any:
        if name not in self._slots:
            if name not in _FACTORIES:
                raise LogicError(
                    f"no resource or factory registered for '{name}'")
            self._slots[name] = _FACTORIES[name](self)
        return self._slots[name]

    def set_resource(self, name: str, value: Any) -> None:
        self._slots[name] = value

    @property
    def device(self) -> torch.device:
        return self.get_resource("device")

    @property
    def generator(self) -> torch.Generator:
        return self.get_resource("generator")

    # -- comms (``comms.inject_comms_on_handle``) ---------------------------
    def set_comms(self, comms) -> None:
        self.set_resource("comms", comms)

    def get_comms(self):
        expects("comms" in self._slots, "no communicator injected on handle")
        return self._slots["comms"]

    def comms_initialized(self) -> bool:
        return "comms" in self._slots

    def set_subcomm(self, key: str, comms) -> None:
        self._slots["sub_comms"] = {**self._slots.get("sub_comms", {}),
                                    key: comms}

    def get_subcomm(self, key: str):
        subs = self._slots.get("sub_comms", {})
        expects(key in subs, "no sub-communicator '%s' on handle", key)
        return subs[key]

    def sync_stream(self, *tensors) -> None:
        """Block until the card's current stream has run the work that
        produced ``tensors`` (with none, the handle's device's stream).
        CPU work is done when it returns, so nothing waits for it."""
        devs = {t.device for t in tensors
                if isinstance(t, torch.Tensor) and t.is_cuda}
        if not tensors and self.device.type == "cuda":
            devs = {self.device}
        for dev in devs:
            torch.cuda.current_stream(dev).synchronize()

    def __repr__(self) -> str:  # pragma: no cover
        return f"Resources(slots={list(self._slots)})"


class DeviceResources(Resources):
    """The handle of pylibraft's ``DeviceResources``:
    ``DeviceResources(device=..., seed=...)`` pins the device and seeds
    the generator; other slots are made on first use."""

    def __init__(self, device: DeviceLike = None, seed: Optional[int] = None):
        super().__init__(device)
        if seed is not None:
            self._slots["generator"] = torch.Generator(
                device=self.device).manual_seed(seed)


# The reference's legacy alias (``raft::handle_t``).
Handle = DeviceResources


def ensure_handle(handle: Optional[Resources],
                  device: DeviceLike = None) -> Resources:
    """``handle``, or a new :class:`DeviceResources` on ``device`` (``cuda``
    by default) when the caller passed none."""
    return handle if handle is not None else DeviceResources(device)


def as_tensor(x, handle: Optional[Resources] = None,
              device: DeviceLike = None) -> torch.Tensor:
    """A tensor stays where it is; anything else (numpy, lists) moves to
    ``handle.device``, else to ``device``, else to ``cuda``."""
    if isinstance(x, torch.Tensor):
        return x
    if handle is not None:
        dev = handle.device
    else:
        dev = resolve_device(device)
    return torch.as_tensor(np.asarray(x), device=dev)


def as_vectors(x, handle: Optional[Resources] = None,
               device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_tensor` for vectors a caller hands an entry point:
    float64 maps to float32, as the reference's ``jnp.asarray`` maps it
    with x64 off; every other dtype (f32, f16, bf16, int8, uint8) stays."""
    t = as_tensor(x, handle, device)
    return t.float() if t.dtype == torch.float64 else t


def as_float(x, handle: Optional[Resources] = None,
             device: DeviceLike = None) -> torch.Tensor:
    """:func:`as_vectors`, with non-floating inputs mapped to float32."""
    t = as_vectors(x, handle, device)
    return t if t.is_floating_point() else t.float()
