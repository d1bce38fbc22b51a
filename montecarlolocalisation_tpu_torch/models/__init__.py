"""Filter models: motion, ray casting, beam sensor, resampling, clustering."""
