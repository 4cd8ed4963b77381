"""The parameter store, the batched worker contract and the PS loop."""
