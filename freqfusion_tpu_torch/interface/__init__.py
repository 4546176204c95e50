"""The NTIRE entry point: main(model_dir, input_path, output_path, device)."""
