"""One module per architecture (``<arch>.py``), found by the ``arch`` key of
a configuration (absent: ``casmvsnet``) through ``harness.architecture``.

Each module defines, as plain functions of the configuration:

- ``reference(config)``: the plain float32 reference, an ``nn.Module``
  under ``reference/`` with ``set_quant(quant)``, whose state-dict names
  the port's model loads; built alike in every process (no entry from the
  global generator);
- ``drawn(model)``: the parameters the seed draws, ``[(state-dict key,
  deviation)]``, in the order of one normal draw (``program.draw_weights``);
  every other entry keeps the value the reference is built with;
- ``port_model(config, weights, device, dtype=None)``: the port's model
  with ``weights``, the port imported inside the function;
- ``flops(config, img_wh, n_views, batch, train=False)``: the frozen count
  of one forward (``train``: one training step) at ``batch`` scenes;
- ``launch_checks(config, train)``: ``{check: (kernel counter, launches a
  map or step)}``, each held on the card as ``compare.launch_gaps`` reads
  it, where the cell's ``limits`` name the check.
"""
