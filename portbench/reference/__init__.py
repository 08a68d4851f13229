"""The plain reference: PyTorch and NumPy only, nothing of the program.

A configuration file names its field's module here by `"reference"`
(`registry.reference`); nothing else in the harness names a field. A
field's module defines (`FIELD`):

  leaf_shapes(cfg)     {leaf name: shape of one object's leaf}, in a fixed
                       order; the encoding's leaves as `encodings.leaf_shapes`
                       names them, the network's by their path below the
                       program's `params["mlp"]`, joined with "." (`w0`,
                       `rgb.w2`); a matrix, (in, out), is a leaf whose last
                       path part starts with `w` (`train.is_matrix`), and
                       one point goes through each once in the forward pass
  init_weights(gen, cfg, n)
                       {leaf: [n, *shape]} fp32 from `gen`, on its device
  fresh_state(params)  the optimizer state of one object at step 0
  step(state, frames, obj, draws, cfg, q)
                       one train step of one object: (new state, logged
                       loss, gradient as the optimizer gets it {leaf})

The shared parts a field builds on: `precision` (the control's rounding),
`encodings` (MX-grid and hash grid), `train` (rays, loss, optimizer chain,
the step around a field's `forward(w, pts, dirs, cfg, q, c)`); `dataset`
reads the frames and the object table.
"""

FIELD = ("leaf_shapes", "init_weights", "fresh_state", "step")
