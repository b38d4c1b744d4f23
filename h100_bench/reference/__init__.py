"""The benchmark's plain reference: the model, its ops, its weights and its training steps in
plain PyTorch. It imports nothing of the program under test."""
