"""Fine-tuning artifacts of the port: the LoRA adapter format."""
