"""Model layer of the port: VGG16 backbone, WESUP module, predict steps."""
