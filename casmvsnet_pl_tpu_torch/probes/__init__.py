"""The card's counterparts of the JAX package's TPU probes (TPU kernels
#9-#13), one module per probe script:

- ``epi2`` (``scripts/probe_epi2.py``, #9): the variance epilogue with
  several depths per thread;
- ``epi3`` (``scripts/probe_epi3.py``, #10 and #11): the variance
  epilogue for V=3 swept by block size, and the lane-prefix copy;
- ``epi5`` (``scripts/probe_epi5.py``, #12): the 4x4 patch epilogue in the
  transposed layout, and the probe's comparison of samplers;
- ``gather`` (``scripts/probe_gather.py``, #13): three Hopper forms of the
  row gather, and the lane gather.

Each module holds its kernels' plain versions and dispatchers, the probe's
inputs and a ``main(device="cuda")`` that checks every configuration
against the plain version and times it on the card:

    python -m casmvsnet_pl_tpu_torch.probes.<name>
"""
