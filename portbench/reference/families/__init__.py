"""The reference models, one file a family: `<family, lower-case>.py` for
the `family` of a configuration's `architecture` (`models.family` finds it).

A family's module gives:

- `leaves(arch, coeffs) -> {name: (shape, kind)}`: every weight, with the
  kinds conv, fc (drawn glorot-uniform, trained, decayed), scale (ones),
  shift (zeros; also a trained bias), trained and not decayed, and mean, var
  (batch-norm statistics, not trained);
- `forward(w, feats, arch, training, keep, dtype, record) -> logits`:
  [B, frames, coeffs] float32 features to [B, classes] float32 logits,
  with `keep` the dropout mask in training and `record` as
  `models.batch_norm` takes it;
- `dropout_shape(arch, batch)`: the shape of the dropout mask a training
  step draws last from its generator (a unit kept with probability
  `arch["dropout_keep_prob"]`), or None where the model has none (then no
  mask is drawn).
"""
