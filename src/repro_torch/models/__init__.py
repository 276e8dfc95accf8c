"""Language-model scaffolding of the port: the dense-transformer family
(``TransformerLM``), its layers, configurations and registry."""
