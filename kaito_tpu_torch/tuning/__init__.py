"""Fine-tuning on the card: LoRA, QLoRA and full (``trainer.Trainer``,
``cli``), the LoRA adapter format (``lora``) and the metrics sidecar."""
