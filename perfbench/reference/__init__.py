"""The plain PyTorch reference: the model (``model.py``) and its training
step (``train.py``). It imports nothing of the port and nothing of JAX."""
