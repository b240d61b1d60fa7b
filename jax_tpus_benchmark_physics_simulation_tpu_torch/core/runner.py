"""Step-loop runners (port of the JAX package's ``core/runner.py``).

The JAX package fuses each loop into one device program (``fori_loop``
inside ``scan``); here they are host loops over eager steps. A sample is
whatever ``observe_fn`` returns, a tensor or a tuple of tensors; the
samples come back ``torch.stack``ed along a new leading axis.
:func:`synchronize` ends a timed region on the card.
"""

from __future__ import annotations

from typing import Any, Callable, Optional, Tuple

import torch

StepFn = Callable[[Any], Any]
ObserveFn = Callable[[Any], Any]


def _stack(samples: list, template):
    """Stacks a list of samples leaf by leaf; ``template`` (one sample) gives
    the shapes of the empty stack when there are no samples."""
    if isinstance(template, tuple):
        return tuple(_stack([s[k] for s in samples], t) for k, t in enumerate(template))
    if not samples:
        return template.new_zeros((0,) + tuple(template.shape))
    return torch.stack(samples)


def run_steps(step_fn: StepFn, state: Any, num_steps: int) -> Any:
    """Advances ``num_steps`` steps, keeping only the final state."""
    for _ in range(max(num_steps, 0)):
        state = step_fn(state)
    return state


def run_trajectory(
    step_fn: StepFn,
    state: Any,
    num_steps: int,
    sample_every: int = 1,
    observe_fn: Optional[ObserveFn] = None,
) -> Tuple[Any, Any]:
    """Advances ``num_steps`` steps, sampling ``observe_fn(state)`` after
    each chunk of ``sample_every`` steps (``num_steps // sample_every``
    samples). The trailing remainder steps run unsampled, so the final state
    reflects exactly ``num_steps``. Returns ``(final_state, samples)``."""
    if observe_fn is None:
        observe_fn = lambda s: s  # noqa: E731
    num_samples = num_steps // sample_every
    samples = []
    for _ in range(num_samples):
        state = run_steps(step_fn, state, sample_every)
        samples.append(observe_fn(state))
    template = samples[0] if samples else observe_fn(state)
    state = run_steps(step_fn, state, num_steps - num_samples * sample_every)
    return state, _stack(samples, template)


def run_trajectory_with_initial(
    step_fn: StepFn,
    state: Any,
    num_steps: int,
    observe_fn: Optional[ObserveFn] = None,
) -> Tuple[Any, Any]:
    """Like :func:`run_trajectory` with ``sample_every=1``, with the initial
    sample prepended: ``num_steps + 1`` samples."""
    if observe_fn is None:
        observe_fn = lambda s: s  # noqa: E731
    first = observe_fn(state)
    final, samples = run_trajectory(step_fn, state, num_steps, 1, observe_fn)
    if isinstance(first, tuple):
        return final, tuple(torch.cat([f[None], s]) for f, s in zip(first, samples))
    return final, torch.cat([first[None], samples])


def synchronize(device: torch.device) -> None:
    """Waits for the card when ``device`` is one (a timed region's end)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
