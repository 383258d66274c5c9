"""Host-side data: the text pipeline and the device feed."""
