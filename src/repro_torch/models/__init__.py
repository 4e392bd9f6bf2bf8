"""The dense-attention language model of the port: config, layers,
attention, the model with its decode cache, and weight conversion from
the reference's parameter tree."""
