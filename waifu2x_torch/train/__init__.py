"""Training-side code of the port. So far the forward half of the int8
layer-6 fake-quantisation (qat.py) and the stream's frame cursor
(checkpoint.py); the loss, the training loop and its checkpoints are not
ported yet."""
