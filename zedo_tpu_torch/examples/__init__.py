"""Runnable examples of the port (`python -m zedo_tpu_torch.examples.<name>`):
quickstart."""
