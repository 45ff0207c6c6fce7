"""Model layer of the port: VGG16 backbone, WESUP module, objectives, and
the train, eval and predict steps."""
