"""Online learning from production verdicts (the port of the JAX package's
``learn/``).

The serving path produces ground truth the offline checkpoint never saw:
verification outcomes, operator feedback and rule-confirmed verdicts. This
package closes the loop:

* :mod:`.episodes` — harvest those labels from the durable store, replay
  recent incident windows into labeled training episodes, and hold them
  in a bounded dedup'd replay buffer mixed with simulator episodes;
* :mod:`.trainer` — the fine-tune from the live params (proximal anchor
  to the serving params) and the eval gate;
* :mod:`.loop` — :class:`OnlineLearner`: harvest → train → gate → hot
  swap into the resident scorers (atomic across tenants) with post-swap
  rollback.
"""
from .episodes import ReplayBuffer, build_episode, harvest_labels
from .loop import OnlineLearner
from .trainer import finetune, make_finetune_step

__all__ = [
    "ReplayBuffer", "build_episode", "harvest_labels",
    "OnlineLearner", "finetune", "make_finetune_step",
]
