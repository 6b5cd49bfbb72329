"""The benchmark's plain reference: MSDA (``msda``), the Deformable DETR
forward (``detr``), its loss and matcher (``loss``) and AdamW
(``adamw``), in plain PyTorch.  It imports nothing of the program, of the
JAX package or of JAX, and works everything out again from the inputs
that the benchmark made."""
