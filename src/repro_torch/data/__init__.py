from repro_torch.data.synthetic import (ClassificationData, lm_sequences,
                                        teacher_classification, token_lm)

__all__ = ["ClassificationData", "lm_sequences", "teacher_classification",
           "token_lm"]
