"""Training of the port: TF1 Adagrad with global-norm clipping, the train
step, the training loop and the eval loop, and the AAN draft's
sequence-level distillation (distill.py)."""
