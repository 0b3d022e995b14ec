"""State estimation: the Kalman filter of the data pipeline."""
