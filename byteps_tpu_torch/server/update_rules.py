"""Per-key server-side update rules (``byteps_tpu.server.update_rules``):
the server-side optimizer plane.

Workers push gradients and pull updated parameters; the key's server runs
the rule, so a worker holds no optimizer state.  Rules are numpy and
deterministic: every operation runs in the store's dtype (hyperparameters
are cast to it at construction), so a server's trajectory is bitwise a
worker applying the same rule to the same gradient sum.

Lifecycle on the server (``server/server.py``):

- declared at INIT by the profile extension (bit 1 of the profile byte)
  with the rule's name and JSON hyperparameters;
- round 1 is the seed round: every worker pushes its initial parameters,
  and the server adopts the first copy as it is, never an average;
- every later completed round calls :meth:`UpdateRule.apply` once with the
  raw gradient sum (the division by the worker count happens inside, in
  the order of the worker engine's average).

Only floating stores carry a rule, and the C++ engine refuses the profile
(``native_server_opt_reject``).
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np

from byteps_tpu_torch.common.config import truthy

#: every rule
RULE_NAMES = ("sgd", "momentum", "adam")


def rule_name(raw) -> Optional[str]:
    """The rule a ``BYTEPS_SERVER_OPT`` value or a ``byteps_server_opt``
    kwarg names, lower-cased; None for an empty value or an off spelling
    (a tensor opted out of a fleet-wide rule)."""
    name = str(raw).strip().lower()
    return name if name and truthy(name) else None


class UpdateRule:
    """Base class: one instance per server-opt key, living in
    ``_KeyState`` behind the key's lock (no locking in here).  ``apply`` mutates ``params`` in place; ``t`` is the
    1-based completed-gradient-round count (Adam bias correction)."""

    name = "?"

    def __init__(self, n: int, dtype: np.dtype, hp: Dict) -> None:
        if not np.issubdtype(dtype, np.floating):
            raise ValueError(
                f"server-side optimizer needs a floating store, got {dtype}"
            )
        self.n = int(n)
        self.dtype = np.dtype(dtype)
        self.hp = dict(hp)
        #: divide the pushed sum by num_workers before the update —
        #: mirrors the engine-side ``job.average`` flag, which the
        #: worker hands off to the server for server-opt keys
        self.average = bool(hp.get("average", True))
        self._lr = self.dtype.type(hp.get("lr", self.default_lr()))

    @staticmethod
    def default_lr() -> float:
        return 0.01

    # -- the update -------------------------------------------------------

    def apply(
        self, params: np.ndarray, grad_sum: np.ndarray,
        num_workers: int, t: int,
    ) -> None:
        grad = grad_sum / num_workers if self.average else grad_sum
        self._update(params, grad, t)

    def _update(self, params: np.ndarray, grad: np.ndarray, t: int) -> None:
        raise NotImplementedError

    # -- state: what rides MIGRATE_STATE behind the accumulator ------------

    def slots(self) -> List[np.ndarray]:
        """Optimizer state arrays, fixed order, store dtype."""
        return []

    def slot_bytes(self) -> List[bytes]:
        return [s.tobytes() for s in self.slots()]

    def load_slot_bytes(self, blobs: List[bytes]) -> None:
        slots = self.slots()
        if len(blobs) != len(slots):
            raise ValueError(
                f"rule {self.name}: expected {len(slots)} slot blobs, "
                f"got {len(blobs)}"
            )
        for slot, blob in zip(slots, blobs):
            arr = np.frombuffer(blob, dtype=self.dtype)
            if arr.size != slot.size:
                raise ValueError(
                    f"rule {self.name}: slot size mismatch "
                    f"({arr.size} != {slot.size})"
                )
            slot[:] = arr

    def state_nbytes(self) -> int:
        return sum(s.nbytes for s in self.slots())


class SGD(UpdateRule):
    """``params -= lr * grad`` — stateless, zero slots."""

    name = "sgd"

    def _update(self, params: np.ndarray, grad: np.ndarray, t: int) -> None:
        params -= self._lr * grad


class Momentum(UpdateRule):
    """Classic (heavy-ball) momentum: ``m = mu*m + grad``,
    ``params -= lr * m``.  One slot."""

    name = "momentum"

    def __init__(self, n: int, dtype: np.dtype, hp: Dict) -> None:
        super().__init__(n, dtype, hp)
        self._mu = self.dtype.type(hp.get("momentum", 0.9))
        self.m = np.zeros(self.n, dtype=self.dtype)

    def _update(self, params: np.ndarray, grad: np.ndarray, t: int) -> None:
        np.multiply(self.m, self._mu, out=self.m)
        self.m += grad
        params -= self._lr * self.m

    def slots(self) -> List[np.ndarray]:
        return [self.m]


class Adam(UpdateRule):
    """Adam (Kingma & Ba): first/second moments + bias correction by
    the completed-round count ``t``.  Two slots."""

    name = "adam"

    @staticmethod
    def default_lr() -> float:
        return 0.001

    def __init__(self, n: int, dtype: np.dtype, hp: Dict) -> None:
        super().__init__(n, dtype, hp)
        self._b1 = self.dtype.type(hp.get("b1", 0.9))
        self._b2 = self.dtype.type(hp.get("b2", 0.999))
        self._eps = self.dtype.type(hp.get("eps", 1e-8))
        self.m = np.zeros(self.n, dtype=self.dtype)
        self.v = np.zeros(self.n, dtype=self.dtype)

    def _update(self, params: np.ndarray, grad: np.ndarray, t: int) -> None:
        one = self.dtype.type(1)
        np.multiply(self.m, self._b1, out=self.m)
        self.m += (one - self._b1) * grad
        np.multiply(self.v, self._b2, out=self.v)
        self.v += (one - self._b2) * (grad * grad)
        m_hat = self.m / (one - self._b1 ** t)
        v_hat = self.v / (one - self._b2 ** t)
        params -= self._lr * (m_hat / (np.sqrt(v_hat) + self._eps))

    def slots(self) -> List[np.ndarray]:
        return [self.m, self.v]


_RULES = {"sgd": SGD, "momentum": Momentum, "adam": Adam}
assert tuple(sorted(_RULES)) == tuple(sorted(RULE_NAMES))


def make_rule(name: str, hp: Dict, n: int, dtype) -> UpdateRule:
    """Factory — raises ``ValueError`` for unknown rules or
    non-floating stores, which the server turns into an INIT
    ``status=1`` rejection (the client explains it)."""
    cls = _RULES.get(str(name))
    if cls is None:
        raise ValueError(
            f"unknown server update rule {name!r} (have {RULE_NAMES})"
        )
    return cls(n, np.dtype(dtype), dict(hp or {}))


def canonical_hp(hp: Dict) -> str:
    """Deterministic JSON for the INIT wire block —
    sorted keys, no whitespace, so equal configs are equal bytes."""
    return json.dumps(dict(hp or {}), sort_keys=True, separators=(",", ":"))


def parse_hp(blob) -> Dict:
    if not blob:
        return {}
    obj = json.loads(blob if isinstance(blob, str) else blob.decode("utf-8"))
    if not isinstance(obj, dict):
        raise ValueError("server-opt hyperparams must be a JSON object")
    return obj


def same_config(rule: UpdateRule, name: str, hp: Dict) -> bool:
    """True when an existing rule instance already matches a freshly
    declared (name, hp) — a re-INIT with the same config keeps the
    slots and step count; a different config rebuilds from zero."""
    return (
        rule is not None
        and rule.name == str(name)
        and canonical_hp(rule.hp) == canonical_hp(hp)
    )
