"""SPT fine-tuning: staged upgrades, trainable partition, train step."""
