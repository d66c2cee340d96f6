"""The optimizer (``repro.optimizer``): hand-rolled AdamW (the proxy
trainer's and the LM trainer's) and int8 gradient compression."""
