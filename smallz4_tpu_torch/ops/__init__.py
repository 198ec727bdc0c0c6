"""Device ops of the PyTorch port: chunk-merge match search and the
stream pipeline around it."""
