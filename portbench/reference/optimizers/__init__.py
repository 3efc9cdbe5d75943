"""The reference updates, one file an optimizer: `<optimizer>.py` for a
configuration's `optim.optimizer` (`train.optimizer` finds it).

An optimizer's module gives:

- `init(params) -> state` for a {name: float32 tensor} mapping;
- `step(params, grads, state, lr, optim) -> (params, state)`: one update at
  learning rate `lr`, the optimizer's constants read from the
  configuration's `optim` section;
- `first_grad(program_state, name) -> tensor`: the gradient of `name` that
  the program's optimizer received at step 1, read back from the program's
  optimizer state after one step.
"""
