"""Models of the PyTorch package."""

from .crnn_ctc import CRNNCTC
from .bert import (BertConfig, BertForPretraining, BertModel,
                   MLMHeadOutput, pretraining_loss)
from .ernie import (ErnieConfig, ErnieForPretraining, ErnieModel,
                    knowledge_mask)
from .gpt_lm import (GPTBlock, GPTConfig, GPTLanguageModel,
                     dense_causal_attention)
from .lstm_lm import LMConfig, LSTMLanguageModel
from .nlp import SentimentBiLSTM, SRLBiLSTMCRF
from .resnet import (BasicBlock, BottleneckBlock, ResNet, resnet18,
                     resnet34, resnet50, resnet101, resnet152,
                     resnext50_32x4d)
from .transformer_seq2seq import Seq2SeqConfig, TransformerSeq2Seq
from .word2vec import NGramLM, SkipGramNCE

__all__ = ["GPTConfig", "GPTBlock", "GPTLanguageModel",
           "dense_causal_attention", "BertConfig", "BertModel",
           "BertForPretraining", "MLMHeadOutput", "pretraining_loss",
           "Seq2SeqConfig", "TransformerSeq2Seq", "BasicBlock",
           "BottleneckBlock", "ResNet", "resnet18", "resnet34", "resnet50",
           "resnet101", "resnet152", "resnext50_32x4d", "ErnieConfig",
           "ErnieModel", "ErnieForPretraining", "knowledge_mask",
           "LMConfig", "LSTMLanguageModel", "CRNNCTC", "SentimentBiLSTM",
           "SRLBiLSTMCRF", "NGramLM", "SkipGramNCE"]
