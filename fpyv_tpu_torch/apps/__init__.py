"""Runnable applications (mirrors ``fpyv_tpu.apps``): PPO training."""
