"""Training-side code of the port. So far the forward half of the int8
layer-6 fake-quantisation (qat.py); the loss and the training loop are not
ported yet."""
